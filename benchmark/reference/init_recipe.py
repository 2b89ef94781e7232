"""The seeded initial parameters, worked out again without the program.

A frozen copy of the recipe the program's trainer draws its fresh state
by: one torch.Generator on the device, seeded once, and every leaf of
spec.leaf_shapes drawn in that order as a whole stacked tensor: norms at
1, every other leaf N(0, init_std) in the leaf's own type. The same seed
on the same device gives the same numbers, so the reference holds the
state the program started from without taking it from the program.
"""

from __future__ import annotations

import torch

from .spec import Spec, leaf_shapes


def leaves(spec: Spec, seed: int, device, want=None):
    """Yields (path, tensor) in draw order. `want` (a set of paths, or
    None for all): leaves outside it are drawn, to keep the generator's
    sequence, and dropped at once."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for path, shape, dtype in leaf_shapes(spec):
        if path.endswith("norm"):
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, spec.init_std, generator=gen)
        if want is None or path in want:
            yield path, t
        del t


def params(spec: Spec, seed: int, device) -> dict:
    """{path: tensor} of every leaf."""
    return dict(leaves(spec, seed, device))
