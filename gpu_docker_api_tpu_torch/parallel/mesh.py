"""Parallelism plans (PyTorch port of gpu_docker_api_tpu/parallel/mesh.py).

The plan and the control plane's env contract: MeshPlan and plan_from_env,
kept identical to the JAX package's so both runtimes read TDAPI_MESH_PLAN
the same way. Torch has no mesh: the one axis ported so far, `sp`, is a
torch.distributed group of ranks (parallel/comm.SPGroup, ring.py,
ulysses.py). require_ported refuses a plan with any other axis above 1.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


@dataclass(frozen=True)
class MeshPlan:
    """How many devices each parallelism axis gets. Axis order = AXES: dp
    outermost, then fsdp, pp, ep, with tp and sp innermost."""
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp

    @classmethod
    def auto(cls, n_devices: int, tp: int = 1, sp: int = 1, pp: int = 1,
             ep: int = 1) -> "MeshPlan":
        """Give tp/sp/pp/ep what was asked, spend the rest on fsdp."""
        fixed = tp * sp * pp * ep
        rest = n_devices // fixed
        if fixed * rest != n_devices:
            raise ValueError(
                f"tp({tp})*sp({sp})*pp({pp})*ep({ep}) must divide device "
                f"count {n_devices}")
        return cls(dp=1, fsdp=rest, pp=pp, ep=ep, tp=tp, sp=sp)


def plan_from_env(env: Optional[dict] = None) -> Optional[MeshPlan]:
    """Parse the control plane's gang mesh contract (TDAPI_MESH_PLAN, a JSON
    dict of axis factors) into a MeshPlan. None when the env carries no
    plan. A malformed value raises: the scheduler shaped the grant for THIS
    plan, so silently building another would put traffic on links the
    placement never promised."""
    e = os.environ if env is None else env
    raw = e.get("TDAPI_MESH_PLAN", "")
    if not raw:
        return None
    try:
        d = json.loads(raw)
    except json.JSONDecodeError as err:
        raise ValueError(f"unparsable TDAPI_MESH_PLAN={raw!r}") from err
    if not isinstance(d, dict):
        raise ValueError(f"TDAPI_MESH_PLAN must be a JSON object, got {raw!r}")
    unknown = sorted(set(d) - set(AXES))
    if unknown:
        raise ValueError(f"TDAPI_MESH_PLAN has unknown axis(es) {unknown}")
    vals = {}
    for a in AXES:
        v = d.get(a, 1)
        # strict: int(2.5) would silently build a smaller mesh than granted
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(
                f"TDAPI_MESH_PLAN.{a} must be a positive integer, got {v!r}")
        vals[a] = v
    return MeshPlan(**vals)


def require_ported(plan: MeshPlan) -> None:
    """Sequence parallelism (`sp`) is the one axis ported; refuse a plan
    with any other axis above 1."""
    others = [a for a in AXES if a != "sp" and getattr(plan, a) > 1]
    if others:
        raise NotImplementedError(
            f"{plan}: the {', '.join(others)} axis is not yet ported to "
            f"PyTorch (only sp is)")
