"""Carry weights between the JAX package and the port.

Both packages keep the same parameter tree ({"embed", "layers": {...},
"final_norm", "lm_head"}, matrices [in, out], layers stacked on [L]), so a
conversion is a leaf-by-leaf copy. The caller hands over the JAX pytree as
numpy arrays (``jax.tree.map(np.asarray, params)``): the port never imports
JAX. bfloat16 leaves move as their raw 16 bits, so the round trip
numpy -> torch -> numpy is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import param_shapes


def _to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(arr, order="C")   # an owned, writable copy for torch
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != dtype:
        raise ValueError(f"leaf dtype {t.dtype} != config dtype {dtype}")
    return t.to(device)


def params_from_numpy(tree: dict, config, device="cpu") -> dict:
    """JAX init_params pytree (numpy leaves) -> the port's parameters on
    `device`. Shapes and dtypes are checked against the config's family
    (models.param_shapes)."""
    def convert(sub, shapes, path):
        if set(sub) != set(shapes):
            raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                             f"{sorted(shapes)}")
        out = {}
        for name, spec in shapes.items():
            if isinstance(spec, dict):
                out[name] = convert(sub[name], spec, f"{path}{name}.")
                continue
            shape, dtype = spec
            if tuple(np.shape(sub[name])) != shape:
                raise ValueError(f"{path}{name}: shape {np.shape(sub[name])}"
                                 f" != {shape}")
            out[name] = _to_tensor(sub[name], dtype, device)
        return out

    return convert(tree, param_shapes(config), "")


def params_to_numpy(params: dict) -> dict:
    """The port's parameters -> numpy leaves (bfloat16 as ml_dtypes'
    bfloat16, the dtype JAX arrays convert to)."""
    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes   # numpy's bfloat16; needed only here
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return convert(params)
