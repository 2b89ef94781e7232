"""Per-layer rematerialization policy for the decoder trunk.

Counterpart of gpu_docker_api_tpu/models/remat.py on torch.utils.checkpoint.
Each decoder layer is checkpointed on its own (never the whole loss, which
would recompute the full forward and still hold every layer's residuals
during the recompute): memory O(L x layer inputs), recompute bounded to one
layer at a time.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

POLICIES = ("none", "full", "dots")

# matrix products without batch dims (the JAX policy
# dots_with_no_batch_dims_saveable): the projections and the MLP
_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(body, remat: str):
    """"full" saves only layer inputs (least memory); "dots" also saves the
    matmul outputs, so the backward's recompute skips the big products.
    Both rerun the rest of the layer — attention included — in the
    backward."""
    if remat not in POLICIES:
        raise ValueError(f"remat {remat!r} not in {POLICIES}")
    if remat == "none":
        return body
    kwargs = {"use_reentrant": False}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    @functools.wraps(body)
    def wrapped(*args):
        return checkpoint(body, *args, **kwargs)

    return wrapped
