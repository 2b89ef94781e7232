"""Control-plane MeshPlan spec: the parallelism shape a gang replicaSet
asks the scheduler to grant.

The port's copy of the JAX control plane's meshplan.py. It is the
WIRE/STORE twin of the workload's MeshPlan (parallel/mesh.py): a plain
dataclass carrying the six axis factors (dp/fsdp/pp/ep/tp/sp, outermost
to innermost — the same order parallel/mesh.AXES documents), with
validation and the env-contract serialization (TDAPI_MESH_PLAN) the
scheduler stamps into a gang container. parallel/mesh.plan_from_env()
parses that env back inside the container, closing the loop: the mesh the
workload builds is exactly the mesh the scheduler granted cards for.

A plan is TRIVIAL when every factor is 1 — the shape every legacy spec
(and every fractional/zero-card request) deserializes to; trivial plans
carry no gang semantics and stamp no env.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

#: axis order, outermost (dp — can ride DCN) to innermost (sp — the
#: chattiest, wants contiguous ICI neighbors under row-major chip order);
#: mirrors parallel/mesh.AXES, which the two modules' tests pin equal
PLAN_AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


@dataclass(frozen=True)
class PlanSpec:
    """How many chips each parallelism axis gets (control-plane view)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp

    @property
    def is_trivial(self) -> bool:
        return self.size == 1

    def factors(self) -> tuple[int, int, int, int, int, int]:
        """(dp, fsdp, pp, ep, tp, sp) — outermost first."""
        return (self.dp, self.fsdp, self.pp, self.ep, self.tp, self.sp)

    @classmethod
    def from_json(cls, d) -> "PlanSpec":
        """Parse a wire meshPlan dict ({} / None -> trivial). Unknown axis
        names and non-positive/non-integer factors raise ValueError with a
        client-facing message — a typo'd axis must not silently become a
        trivial plan."""
        if not d:
            return cls()
        if not isinstance(d, dict):
            raise ValueError(f"meshPlan must be an object of axis factors, "
                             f"got {type(d).__name__}")
        unknown = sorted(set(d) - set(PLAN_AXES))
        if unknown:
            raise ValueError(f"meshPlan has unknown axis(es) {unknown}; "
                             f"valid axes: {list(PLAN_AXES)}")
        vals = {}
        for a in PLAN_AXES:
            v = d.get(a, 1)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"meshPlan.{a} must be a positive integer, "
                                 f"got {v!r}")
            vals[a] = v
        return cls(**vals)

    @classmethod
    def from_spec(cls, mesh_plan: dict) -> "PlanSpec":
        """From a stored ContainerSpec.mesh_plan dict ({} = legacy/trivial).
        Stored plans were validated at admission; this is the lenient
        reader for records."""
        if not mesh_plan:
            return cls()
        return cls(**{a: int(mesh_plan.get(a, 1)) for a in PLAN_AXES})

    def to_json(self) -> dict:
        return {a: getattr(self, a) for a in PLAN_AXES}

    def to_env(self) -> str:
        """The TDAPI_MESH_PLAN env value (JSON, sorted keys — byte-stable
        so env comparisons across versions behave)."""
        return json.dumps(self.to_json(), sort_keys=True)

    def validate_count(self, tpu_count) -> None:
        """A non-trivial plan must multiply to a WHOLE tpuCount: gang
        workloads hold whole chips (a fractional share cannot host a
        mesh axis), and the factors are exactly how those chips will be
        reshaped into a device mesh."""
        c = float(tpu_count)
        if c != int(c):
            raise ValueError(
                f"meshPlan requires a whole-chip tpuCount (gang workloads "
                f"cannot run on a fractional share); got {tpu_count}")
        if int(c) != self.size:
            raise ValueError(
                f"meshPlan factors {self.to_json()} multiply to "
                f"{self.size}, but tpuCount is {tpu_count} — the product "
                f"must equal tpuCount")

    def __str__(self) -> str:
        return "x".join(f"{a}={getattr(self, a)}" for a in PLAN_AXES
                        if getattr(self, a) > 1) or "trivial"


def stored_plan(plan: PlanSpec, plan_json, whole: int):
    """The ONE rule for what lands in ContainerSpec.mesh_plan (and so is
    stamped as TDAPI_MESH_PLAN): any non-trivial plan; or a trivial one
    the request explicitly spelled out — a NON-EMPTY meshPlan object —
    on a single whole chip (pins the workload to a 1-device mesh, the
    dp=1 leg of a reshard cycle on over-provisioned virtual-device
    runs). meshPlan={} (and absent) means NO plan: legacy auto-mesh —
    which is also why a rollback can pass a pre-gang version's stored {}
    through here and land back on plan-less semantics. Returns the
    PlanSpec to store, or None. Shared by run_container and _patch_tpu
    so the two admission paths can never drift."""
    if not plan.is_trivial:
        return plan
    if plan_json and whole == 1:
        return plan
    return None
