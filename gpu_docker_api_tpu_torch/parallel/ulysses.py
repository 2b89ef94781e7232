"""Ulysses sequence parallelism: all-to-all head scatter, sequence gather.

PyTorch port of gpu_docker_api_tpu/parallel/ulysses.py, the second
long-context strategy beside ring attention (LlamaConfig.sp_attn picks
one). With the sequence sharded over `sp`, one all-to-all re-partitions
q/k/v from sequence-sharded to head-sharded: each rank then runs ordinary
full-sequence attention (the kernels on the card) over H/sp heads, and a
last all-to-all restores sequence sharding. Inputs and outputs are the
rank's local shards [B, S/sp, H, D]; every rank of the group must call it
together.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import attention as _local_attention
from .comm import SPGroup, all_to_all


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sp: Optional[SPGroup], causal: bool = True,
                      impl: str = "auto", window: int = 0,
                      tp: int = 1) -> torch.Tensor:
    """q [B, S/sp, H, D], k/v [B, S/sp, Hkv, D] -> [B, S/sp, H, D]. Needs
    H % sp == 0 (KV heads are replicated up to the group first when
    Hkv % sp != 0); `tp` is how many tp ranks the model's heads were
    split over before (1 when they are whole here), named in the refusal
    as JAX names it. A window applies unchanged: after the head scatter
    each rank holds the whole sequence of its heads."""
    if sp is None or sp.size == 1:
        return _local_attention(q, k, v, causal=causal, impl=impl,
                                window=window)
    if q.shape[2] % sp.size != 0:
        raise ValueError(f"n_heads {q.shape[2] * tp}/tp={tp} must divide by "
                         f"sp {sp.size} for Ulysses")
    return _ulysses_local(q, k, v, sp=sp, causal=causal, impl=impl,
                          window=window)


def _ulysses_local(q, k, v, *, sp: SPGroup, causal: bool, impl: str,
                   window: int = 0):
    """Per-rank body. q [B, S/sp, H, D]; k/v [B, S/sp, Hkv, D]."""
    n = sp.size
    hkv = k.shape[2]
    if hkv % n != 0:
        # replicate KV heads up to the GQA group so the head axis splits
        rep = n // hkv if n % hkv == 0 else q.shape[2] // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # sequence-sharded -> head-sharded: split heads, gather the sequence
    qh, kh, vh = all_to_all((q, k, v), 2, 1, sp)     # [B, S, H/sp, D]
    out = _local_attention(qh, kh, vh, causal=causal, impl=impl,
                           window=window)
    # head-sharded -> sequence-sharded: split the sequence, gather heads
    return all_to_all((out,), 1, 2, sp)[0]
