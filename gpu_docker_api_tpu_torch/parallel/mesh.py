"""Parallelism plans (PyTorch port of gpu_docker_api_tpu/parallel/mesh.py).

The plan and the control plane's env contract: MeshPlan and plan_from_env,
kept identical to the JAX package's so both runtimes read TDAPI_MESH_PLAN
the same way. Torch has no mesh: make_mesh lays the plan's ranks out
row-major over AXES, as the JAX mesh lays out its devices, and
MeshGroups forms one torch.distributed group per axis above 1
(parallel/comm.AxisGroup). The sharding rules are the JAX package's
PartitionSpecs, written as tuples of axis names per dim: tp splits each
matrix Megatron-style (column-parallel in, row-parallel out, the vocab of
embed and lm_head) and fsdp the other dim (ZeRO-3); a dim named by both
(embed's) is cut into tp x fsdp chunks, tp major, as JAX places it; ep
cuts the expert banks' expert dim; pp cuts the stacked layer dim of the
decoder layers (train.param_specs), each stage holding its own layers. The
batch rows go over dp x fsdp x ep, the sequence over sp and the logits'
vocab over tp.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .comm import AxisGroup

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


def make_mesh(plan: MeshPlan) -> np.ndarray:
    """The ranks of the plan laid out over AXES: an int array of shape
    (dp, fsdp, pp, ep, tp, sp), row-major, as the JAX make_mesh reshapes
    its device list. Rank r sits at the coordinates where it appears."""
    return np.arange(plan.size).reshape(
        [getattr(plan, a) for a in AXES])


def coords(plan: MeshPlan, rank: int) -> dict:
    """{axis: this rank's index along it} (make_mesh's layout)."""
    at = np.unravel_index(rank, [getattr(plan, a) for a in AXES])
    return {a: int(i) for a, i in zip(AXES, at)}


def axis_lines(plan: MeshPlan, axes: tuple) -> list:
    """The groups of ranks that differ only along `axes`: one list of
    ranks per setting of the other axes, each in row-major order, the
    groups in row-major order of the other axes."""
    mesh = make_mesh(plan)
    inner = [AXES.index(a) for a in AXES if a in axes]
    outer = [i for i in range(len(AXES)) if i not in inner]
    lines = mesh.transpose(outer + inner).reshape(
        -1, int(np.prod([mesh.shape[i] for i in inner], dtype=int)))
    return [[int(r) for r in line] for line in lines]


# ---- logical sharding rules -------------------------------------------------

def param_sharding_rules() -> dict:
    """The JAX PartitionSpec of each parameter kind as a tuple with one
    entry per dim: None (not sharded), an axis name, or a tuple of axis
    names (major first). fsdp shards the other axis of every matrix from
    the one tp splits (Megatron column-parallel in, row-parallel out)."""
    return {
        "embed": (("tp", "fsdp"), None),        # [V, D] vocab-parallel
        "attn_in": ("fsdp", "tp"),              # [D, heads*head_dim]
        "attn_out": ("tp", "fsdp"),             # [heads*head_dim, D]
        "mlp_in": ("fsdp", "tp"),               # [D, F] (w1, w3)
        "mlp_out": ("tp", "fsdp"),              # [F, D] (w2)
        "norm": (None,),                        # [D]
        "lm_head": ("fsdp", "tp"),              # [D, V]
        "router": (None, None),                 # [D, E]
        "expert_in": ("ep", "fsdp", "tp"),      # [E, D, F]
        "expert_out": ("ep", "tp", "fsdp"),     # [E, F, D]
    }


BATCH_AXES = ("dp", "fsdp", "ep")

# the axes that split parameters: those of the rules above, fsdp first, the
# minor axis where two cut one dim (embed's); ep cuts a dim of its own (the
# banks' experts) and pp the stacked layer dim (train.param_specs)
PARAM_AXES = ("fsdp", "tp", "ep", "pp")

# the axes over which a parameter's gradient is a partial sum, less the
# ones that cut it (MeshGroups.sum_group); tp's ranks hold the whole
# gradient of what they share
SUM_AXES = ("dp", "fsdp", "pp", "ep", "sp")


def batch_spec() -> tuple:
    """Integer token batches [batch, seq]: rows over the data axes, the
    sequence over sp."""
    return (BATCH_AXES, "sp")


def logits_spec() -> tuple:
    """[batch, seq, vocab]: the vocab over tp keeps the big tensor
    sharded."""
    return (BATCH_AXES, "sp", "tp")


def head_axis_for(tp: int, n_heads: int, n_kv_heads: int) -> Optional[str]:
    """The axis an attention-head dim is sharded over: tp when both head
    counts divide by it (attention is independent per head), else None:
    the heads are gathered whole on every tp rank (the correctness
    fallback for odd GQA configs). JAX's takes the mesh; this, its tp."""
    if tp > 1 and n_heads % tp == 0 and n_kv_heads % tp == 0:
        return "tp"
    return None


def best_tp_for(n_devices: int, max_tp: int = 8) -> int:
    """Largest power-of-two tp <= max_tp dividing n_devices."""
    tp = 1
    while tp * 2 <= max_tp and n_devices % (tp * 2) == 0:
        tp *= 2
    return tp


def spec_dim(spec: tuple, axis: str) -> Optional[int]:
    """The dim of `spec` that `axis` shards, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None


def split_dims(spec: tuple, plan: MeshPlan) -> tuple:
    """((axis, the dim it cuts), ...) of a leaf of `spec` under `plan`,
    for the PARAM_AXES above 1 that the spec names, in PARAM_AXES order;
    () for a whole leaf."""
    return tuple((a, spec_dim(spec, a)) for a in PARAM_AXES
                 if getattr(plan, a) > 1 and spec_dim(spec, a) is not None)


def shard_slices(shape, spec: tuple, plan: MeshPlan, rank: int,
                 name: str = "leaf") -> tuple:
    """The slices of a whole leaf of `shape` that rank `rank` of `plan`
    holds: each dim its spec names cut into the product of its axes'
    sizes, the chunk at this rank's coordinates (row-major over the axes,
    major first: embed's ("tp", "fsdp") takes chunk tp * fsdp_size +
    fsdp). A dim that does not divide raises ValueError, as the JAX
    device_put of an uneven sharding does."""
    at = coords(plan, rank)
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a is not None and getattr(plan, a) > 1]
        size, index = 1, 0
        for a in axes:
            size *= getattr(plan, a)
            index = index * getattr(plan, a) + at[a]
        if shape[dim] % size:
            over = " x ".join(f"{a} {getattr(plan, a)}" for a in axes)
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does not "
                             f"divide over {over}")
        n = shape[dim] // size
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)


def shard(x: torch.Tensor, spec: tuple, plan: MeshPlan, rank: int,
          name: str = "leaf") -> torch.Tensor:
    """Rank `rank`'s shard of the whole leaf x (a view; x itself when
    nothing splits it): shard_slices."""
    return x[shard_slices(x.shape, spec, plan, rank, name)]


def unshard(pieces, spec: tuple, plan: MeshPlan) -> torch.Tensor:
    """The whole leaf that every rank's shard (pieces[r], in rank order)
    was cut from."""
    shape = list(pieces[0].shape)
    for dim, entry in enumerate(spec):
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a is not None:
                shape[dim] *= getattr(plan, a)
    out = pieces[0].new_empty(shape)
    for rank, piece in enumerate(pieces):
        out[shard_slices(shape, spec, plan, rank)] = piece
    return out


def shard_params(params: dict, specs: dict, plan: MeshPlan, rank: int,
                 prefix: str = "") -> dict:
    """Rank `rank`'s shard of each leaf (param_specs gives each leaf's
    spec)."""
    return {k: shard_params(v, specs[k], plan, rank, f"{prefix}{k}.")
            if isinstance(v, dict) else
            shard(v, specs[k], plan, rank, prefix + k)
            for k, v in params.items()}


@dataclass(frozen=True)
class MeshGroups:
    """This rank's place in the plan's process groups: one AxisGroup per
    axis above 1 (None at size 1); `data` over every axis but tp (the
    ranks over which a tp-replicated value, the loss, a norm's or the
    router's gradient, is a partial sum, and over which MoE routes: its
    ranks run row shard major, sp minor); `routes` over dp x fsdp x ep,
    the ranks whose rows make one microbatch of the pipeline, over which a
    pipelined MoE layer routes; `world` over every rank (None alone); and
    through sum_group, from the axes that cut a leaf, the ranks that hold
    the same shard of it, over which its gradient sums (dp x ep x sp for
    a matrix, dp x sp for an expert bank, pp too for embed and
    lm_head)."""
    plan: MeshPlan
    rank: int
    dp: Optional[AxisGroup] = None
    fsdp: Optional[AxisGroup] = None
    pp: Optional[AxisGroup] = None
    ep: Optional[AxisGroup] = None
    tp: Optional[AxisGroup] = None
    sp: Optional[AxisGroup] = None
    data: Optional[AxisGroup] = None
    routes: Optional[AxisGroup] = None
    world: Optional[AxisGroup] = None
    # frozenset(cut axes) -> the group over SUM_AXES less them
    sums: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def rows(self) -> tuple[int, int]:
        """(this rank's row shard, how many): the batch rows go over dp x
        fsdp x ep, dp major, ep minor (BATCH_AXES); the pp, tp and sp
        ranks of a row shard take the same rows."""
        c, p = coords(self.plan, self.rank), self.plan
        return ((c["dp"] * p.fsdp + c["fsdp"]) * p.ep + c["ep"],
                p.dp * p.fsdp * p.ep)

    def sum_group(self, cut) -> Optional[AxisGroup]:
        """The group over which the gradient of a leaf cut by the axes
        `cut` is a partial sum: the ranks that hold the same shard, along
        SUM_AXES (fsdp's reduce-scatter already done in the backward, and
        tp's ranks each holding the whole gradient of what they share)."""
        return self.sums[frozenset(cut) & frozenset(SUM_AXES)]

    @classmethod
    def build(cls, plan: MeshPlan) -> "MeshGroups":
        """Form the groups over the default torch.distributed group, whose
        ranks are the plan's. Collective: every rank calls it and forms
        every group in the same order; an axis that spans the world takes
        the default group, and axes over the same ranks share one."""
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != plan.size:
            raise ValueError(f"{plan} needs {plan.size} ranks, the group "
                             f"has {world}")
        formed: dict = {}

        def group(*axes):
            lines = axis_lines(plan, axes)
            if len(lines[0]) == 1:
                return None
            key = tuple(map(tuple, lines))
            if key not in formed:
                mine = None
                if len(lines[0]) < world:
                    mine, _ = dist.new_subgroups_by_enumeration(lines)
                formed[key] = AxisGroup.of(mine)
            return formed[key]

        axes = {a: group(a) for a in AXES}
        out = dict(data=group(*(a for a in AXES if a != "tp")),
                   routes=group("dp", "fsdp", "ep"),
                   world=group(*AXES))
        sums = {}
        for n in range(1 << 3):         # every subset of the cutting axes
            cut = frozenset(a for i, a in enumerate(("fsdp", "ep", "pp"))
                            if n >> i & 1)
            sums[cut] = group(*(a for a in SUM_AXES if a not in cut))
        return cls(plan=plan, rank=rank, **axes, **out, sums=sums)
