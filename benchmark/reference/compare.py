"""The numbers that decide `correct`, from the program's readings and the
reference's, and their verdict against a cell's limits.

Training, after the first three steps of one state driven from the seed:
- loss_gap: the largest relative gap between a step's loss and the
  reference's;
- grad_gap: the worst leaf's gap between the norm of the first step's
  gradient as the optimizer took it (clipped) and the reference's;
- change_gap: the worst leaf's gap between the norm of the parameters'
  change over the three steps and the reference's;
- grad_diff: the worst leaf's norm of the difference between the first
  step's gradient as the optimizer took it and the reference's. The gaps
  of norms above are blind to rounding noise, which adds to a norm in
  quadrature: on these models a float8 control moves no norm by three
  times what sound runs do, and this number is the one it fails.
A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under MOVE_FLOOR of the median leaf's take no part:
they move by rounding alone.

Serving: served_gap, the widest gap by which a served token's reference
logit lies below the reference's best at that position.

A cell compares the numbers its limits file (limits/<cell>.json) gives a
limit; the others are reported beside them.
"""

from __future__ import annotations

import math
import statistics

import torch

MOVE_FLOOR = 1e-3


def _worst_leaf(prog: dict, ref: dict, leaves, scale=None
                ) -> tuple[float, str]:
    """The largest |prog - ref| of a leaf over the larger of the scale's
    value for that leaf and for the median leaf (scale: ref itself)."""
    scale = scale or ref
    med = statistics.median(scale[p] for p in leaves)
    worst, which = 0.0, ""
    for p in leaves:
        gap = abs(prog[p] - ref[p]) / max(scale[p], med)
        if not math.isfinite(gap):
            return math.inf, p
        if gap >= worst:
            worst, which = gap, p
    return worst, which


def moving_leaves(ref_grads: dict) -> list:
    med = statistics.median(ref_grads.values())
    return sorted(p for p, g in ref_grads.items() if g >= MOVE_FLOOR * med)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"loss": [per step], "first_grads": {leaf: norm},
    "change": {leaf: norm}} -> {number: value}, plus "worst" naming the
    leaf behind each leaf number."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the two sides ran different numbers of steps")
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["loss"], ref["loss"]))
    leaves = moving_leaves(ref["first_grads"])
    grad, grad_leaf = _worst_leaf(prog["first_grads"], ref["first_grads"],
                                  leaves)
    change, change_leaf = _worst_leaf(prog["change"], ref["change"], leaves)
    diff, diff_leaf = _worst_leaf(ref["first_diff"],
                                  {p: 0.0 for p in leaves}, leaves,
                                  scale=ref["first_grads"])
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_diff": diff,
            "worst": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                      "grad_diff": diff_leaf,
                      "left_out": sorted(set(ref["first_grads"])
                                         - set(leaves))}}


def served_gap(ref_logits: list, served: list) -> float:
    """ref_logits: [logits [n, V]] per sampled request; served: [[n token
    ids]]. The widest (best - served token's logit) over every position."""
    worst = 0.0
    for logits, toks in zip(ref_logits, served):
        idx = torch.as_tensor(toks, device=logits.device)[:, None]
        gap = logits.max(dim=-1).values - logits.gather(-1, idx)[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for every number that has a
    limit. A number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
