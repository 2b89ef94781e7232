"""Ring attention: sequence parallelism over an `sp` group.

PyTorch port of gpu_docker_api_tpu/parallel/ring.py. Each rank holds the
rank-th S/sp shard of q, k and v; the K/V shards rotate round the ring one
hop a step (comm.ring_shift_start: rank -> rank + 1), each hop posted before
the current pair is computed and waited for after it, so the transfer
overlaps the compute as XLA's ppermute does in the JAX ring. No rank holds
the full K/V or an [S, S] score matrix.

Torch has no global array: inputs and outputs are the rank's local shards
[B, S/sp, H, D], and the group (comm.SPGroup) takes the mesh's place. The
rank is a host int, so the JAX lax.cond over visibility is a Python branch.

Bodies: _ring_local_flash runs each step's pair through flash_attention_lse
(the kernels on the card) and merges the (out, lse) partials online
(_merge_partial); _ring_local_windowed stops rotating once the shards leave
the window; _ring_local is the fused-einsum body that impl="xla" pins.

Gradients sum in f32: each body holds f32 copies of q and of the K/V shard
in hand, casts them back to the input dtype for each pair (exact), and the
hops send K/V in the input dtype but their cotangents in f32. So a shard's
gradient sums its pairs' and hops' in f32 and rounds once; the JAX ring
sums bf16 cotangents in bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import _check_window, _pair_lse_banded
from ..ops.attention import attention as _local_attention
from ..ops.attention import flash_attention_lse
from .comm import SPGroup, ring_shift_start, tie_hops


def _use_flash(impl: str) -> bool:
    """Every impl but "xla" runs the kernels: the port has no TPU
    crossover (ops/attention.py), and "xla" pins the einsum body."""
    if impl not in ("flash", "xla", "auto", "auto_grad"):
        raise ValueError(f"impl {impl!r}: flash|xla|auto|auto_grad")
    return impl != "xla"


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp: Optional[SPGroup], causal: bool = True,
                   impl: str = "auto", window: int = 0) -> torch.Tensor:
    """q [B, S/sp, H, D], k/v [B, S/sp, Hkv, D]: this rank's shards of a
    sequence sharded over `sp` -> this rank's shard of the output
    [B, S/sp, H, D]. Every rank of the group must call it together.

    window > 0 = sliding-window attention (causal): the ring makes only
    min(sp - 1, ceil((window - 1) / (S/sp))) hops."""
    if sp is None or sp.size == 1:
        return _local_attention(q, k, v, causal=causal, impl=impl,
                                window=window)
    return ring_body_auto(q, k, v, sp=sp, causal=causal, impl=impl,
                          window=window)


def ring_body_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   sp: SPGroup, causal: bool, impl: str = "auto",
                   window: int = 0) -> torch.Tensor:
    """The per-rank ring body with ring_attention's flash/einsum dispatch
    (impl="xla" pins the einsum body: the numerics oracle never becomes
    the kernel it exists to check)."""
    _check_window(causal, window)
    use_flash = _use_flash(impl)
    if window:
        return _ring_local_windowed(q, k, v, sp=sp, window=window,
                                    use_flash=use_flash)
    if use_flash:
        return _ring_local_flash(q, k, v, sp=sp, causal=causal)
    return _ring_local(q, k, v, sp=sp, causal=causal)


def _accumulators(q):
    b, s_loc, h, d = q.shape
    num = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), float("-inf"), device=q.device)
    return num, den, m


def _f32(q, k, v):
    """(q's dtype, f32 q, k, v): what a body holds, so that every gradient
    sums in f32 (the module doc)."""
    return q.dtype, q.float(), k.float(), v.float()


def _finish(num, den, dtype, *received):
    """The merged output, with the last hop's tensors tied in (tie_hops)."""
    out = (num / den.transpose(1, 2)[..., None].clamp_min(1e-30)).to(dtype)
    return tie_hops(out, *received)


def _ring_local_flash(q, k, v, *, sp: SPGroup, causal: bool):
    """The ring through the kernels: each step holds one rank's K/V shard
    (disjoint key sets), computes that pair's flash attention with its lse
    and merges it. Visibility in global causal order: src == my is the
    causal diagonal, src < my a full pair, src > my nothing (the merge of
    an empty partial is the identity, so it is skipped; the hop is not)."""
    my, n = sp.rank, sp.size
    dtype, q32, k_cur, v_cur = _f32(q, k, v)
    num, den, m = _accumulators(q)
    # n - 1 (compute, rotate) steps, then a last compute with no rotation
    for i in range(n):
        hop = (ring_shift_start((k_cur, v_cur), sp, dtype) if i < n - 1
               else None)
        src = (my - i) % n
        if not causal or src <= my:
            o, lse = flash_attention_lse(
                q32.to(dtype), k_cur.to(dtype), v_cur.to(dtype),
                causal=causal and src == my)
            num, den, m = _merge_partial(num, den, m, o, lse)
        if hop is not None:
            k_cur, v_cur = hop.wait()
    return _finish(num, den, q.dtype, k_cur, v_cur)


def _merge_partial(num, den, m, o, lse):
    """Online merge of one disjoint-key-set partial (o softmax-normalized
    within its set, lse [B,H,S]) into the (num, den, m) accumulator: the
    math of merge_attention_partials, streamed. -inf rows take nothing."""
    m_new = torch.maximum(m, lse)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe),
                    torch.zeros_like(lse))
    aq = alpha.transpose(1, 2)[..., None]
    wq = w.transpose(1, 2)[..., None]
    num = num * aq + o.float() * wq
    den = den * alpha + w
    return num, den, m_new


def _ring_local_windowed(q, k, v, *, sp: SPGroup, window: int,
                         use_flash: bool):
    """Sliding-window ring: only ceil((window - 1) / s_loc) hops happen at
    all (capped at sp - 1). The diagonal shard runs the windowed kernel
    (the banded einsum when use_flash is off); the shards behind it use
    the banded einsum pair, whose mask keeps at most `window` columns. A
    wrapped shard (my < i) is a future position: skipped, but the rank
    still takes part in the hop."""
    b, s_loc, h, d = q.shape
    my, n = sp.rank, sp.size
    n_back = min(n - 1, -(-(window - 1) // s_loc)) if window > 1 else 0
    dtype, q32, k_cur, v_cur = _f32(q, k, v)
    num, den, m = _accumulators(q)
    for i in range(n_back + 1):
        hop = (ring_shift_start((k_cur, v_cur), sp, dtype) if i < n_back
               else None)
        if i == 0:
            if use_flash:
                o, lse = flash_attention_lse(
                    q32.to(dtype), k_cur.to(dtype), v_cur.to(dtype),
                    causal=True, window=window)
            else:
                o, lse = _pair_lse_banded(q32, k_cur, v_cur, 0, window)
            num, den, m = _merge_partial(num, den, m, o, lse)
        elif my >= i:
            o, lse = _pair_lse_banded(q32, k_cur, v_cur, i * s_loc, window)
            num, den, m = _merge_partial(num, den, m, o, lse)
        if hop is not None:
            k_cur, v_cur = hop.wait()
    return _finish(num, den, q.dtype, k_cur, v_cur)


def _ring_local(q, k, v, *, sp: SPGroup, causal: bool):
    """The fused-einsum body (f32): each step's scores against the K/V
    shard held, masked at global positions, folded into a running max,
    normalizer and accumulator."""
    b, s_loc, h, d = q.shape
    group = h // k.shape[2]
    my, n = sp.rank, sp.size
    dtype, q32, k_cur, v_cur = _f32(q, k, v)
    qf = q32 * (1.0 / math.sqrt(d))
    iota = torch.arange(s_loc, device=q.device)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    for i in range(n):
        hop = (ring_shift_start((k_cur, v_cur), sp, dtype) if i < n - 1
               else None)
        src = (my - i) % n              # whose shard this step holds
        kf = k_cur.repeat_interleave(group, dim=2)
        vf = v_cur.repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        if causal:
            rows = my * s_loc + iota[:, None]
            cols = src * s_loc + iota[None, :]
            s = s.masked_fill(~(cols <= rows), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                        torch.zeros_like(s))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * _bcast(alpha) + torch.einsum("bhqk,bkhd->bqhd", p, vf)
        m = m_new
        if hop is not None:
            k_cur, v_cur = hop.wait()
    out = acc / l.clamp_min(1e-30).transpose(1, 2)
    return tie_hops(out.to(q.dtype), k_cur, v_cur)


def _bcast(alpha: torch.Tensor) -> torch.Tensor:
    """[B,H,S,1] -> [B,S,H,1] to scale the [B,S,H,D] accumulator."""
    return alpha.transpose(1, 2)
