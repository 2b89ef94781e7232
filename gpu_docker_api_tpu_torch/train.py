"""Training loop of the flagship workload, PyTorch port of gpu_docker_api_tpu/train.py.

Next-token cross-entropy in f32, AdamW written out to match the JAX
package's optax chain (clip_by_global_norm, then adamw with decay on every
leaf), gradient accumulation with f32 sums, atomic torch.save checkpoints
(one directory per step) and the byte-compatible quiesce protocol the
control plane's Backend.quiesce drives.

On one device, or on this rank of a plan over dp, fsdp, pp, ep, tp and
sp (parallel/mesh.MeshGroups): each rank takes its B/(dp*fsdp*ep) rows of
the global batch (the pp and tp ranks of a row shard the same rows) and
its S/sp positions, and holds 1/(fsdp*tp) of every matrix and its AdamW
moments (the MoE banks also 1/ep, by expert; under pp the decoder layers
also 1/pp, its stage's), cut along the dims its kind's rule names
(param_specs; the norms and the router whole). The loss is the global
mean (each rank's log-likelihood sum over the global count; under tp the
cross-entropy runs over the vocab shards; MoE adds each rank's share of
the router loss, routed over the global batch, or under pp over each
microbatch: parallel/pipeline.py). A sharded leaf's gradient is
reduce-scattered over fsdp in the backward (comm.all_gather) and summed,
in f32, over the ranks that hold the same shard, tp's aside
(MeshGroups.sum_group): dp x ep x sp for a matrix, dp x sp for a bank cut
over ep, every axis but tp for a whole leaf, and pp too for embed and
lm_head, which every stage holds whole and one stage uses. The loss sums
over every axis but tp. The clip takes the global norm, so each step is
the one-rank step on the global batch; under accumulation (and under pp,
per microbatch) a rank's micro-slice i is its rows of the global
micro-slice i, so MoE routes each micro-slice as one rank does.
Checkpoints hold the gathered state, so one written under any plan
restores under any other; under the interleaved schedule the layers are
stored grouped, [v, pp, L/(v*pp), ...], as JAX stores them, and such a
checkpoint restores only under the same pp and v.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .data import to_device
from .device import resolve_device
from .models import family_for, param_shapes
from .models.llama import init_from_shapes, sharded
from .obs import trace
from .parallel import comm
from .parallel.mesh import (
    PARAM_AXES, MeshGroups, MeshPlan, param_sharding_rules, shard,
    shard_params, split_dims,
)
from .parallel.pipeline import _check_divisible, group_layers, pipeline_loss


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # LR schedule: warmup_steps > 0 enables linear warmup; decay_steps > 0
    # adds cosine decay to min_lr_ratio * peak after warmup. Both 0 =
    # constant LR.
    warmup_steps: int = 0
    decay_steps: int = 0
    min_lr_ratio: float = 0.1
    # accumulate gradients over this many equal micro-slices of the batch
    # before the optimizer update (f32 sums; for llama this equals the
    # full-batch step: mean CE is linear in equal slices; MoE routes and
    # takes its router loss per micro-slice, as the JAX package does)
    accum_steps: int = 1
    remat: bool = True   # per-layer checkpointing of the decoder body
    # "dots" saves matmul outputs across the remat boundary; "full" saves
    # only layer inputs (least memory, forward recomputed on backward)
    remat_policy: str = "dots"
    n_microbatches: int = 4  # pipeline microbatches when the plan has pp > 1
    # >1 selects the interleaved pipeline schedule (v layer chunks per
    # stage, bubble/v: parallel/pipeline.py)
    virtual_stages: int = 1


# ---- optimizer --------------------------------------------------------------

def make_schedule(tc: TrainConfig):
    """The LR: a constant, or count -> LR with the optax shapes (linear
    warmup from 0, then cosine decay to min_lr_ratio * peak, joined at the
    warmup boundary)."""
    if not tc.warmup_steps and not tc.decay_steps:
        return tc.learning_rate
    peak = tc.learning_rate
    parts, bounds = [], []
    if tc.warmup_steps:
        w = tc.warmup_steps
        parts.append(lambda n: peak * min(max(n, 0), w) / w)
        bounds.append(w)
    if tc.decay_steps:
        d, alpha = tc.decay_steps, tc.min_lr_ratio

        def cosine(n):
            frac = 0.5 * (1 + math.cos(math.pi * min(n, d) / d))
            return peak * ((1 - alpha) * frac + alpha)
        parts.append(cosine)
    else:
        parts.append(lambda n: peak)

    def schedule(count: int) -> float:
        out = parts[0](count)
        for boundary, part in zip(bounds, parts[1:]):
            if count >= boundary:
                out = part(count - boundary)
        return out
    return schedule if bounds else parts[0]


def tree_leaves(tree: dict) -> list:
    """Leaves of a nested dict in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_map_named(fn, tree: dict, *rest: dict, prefix: str = "") -> dict:
    """fn(path, leaf, *the leaves of `rest` at the same place) over nested
    dicts of one structure; a path is "layers.wq"."""
    return {k: tree_map_named(fn, v, *(r[k] for r in rest),
                              prefix=f"{prefix}{k}.")
            if isinstance(v, dict) else fn(prefix + k, v,
                                           *(r[k] for r in rest))
            for k, v in tree.items()}


def sum_squares(tensors) -> torch.Tensor:
    """The sum of squares over every leaf, in f32."""
    return sum((t.float() * t.float()).sum() for t in tensors)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum_squares(tensors))


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps=1e-8,
    weight_decay)) written out, with optax's numerics:

    - the clip scales by clip / norm only when norm >= clip (no epsilon);
    - the moments live in the params' dtype (optax's mu_dtype=None);
    - eps is added outside the square root; bias correction uses the
      incremented count, the LR schedule the count before it;
    - weight decay applies to every leaf, norms included.

    Updates are in place on the parameters and moments."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.lr = make_schedule(tc)
        self.eps = 1e-8

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list,
               norm: Optional[torch.Tensor] = None) -> None:
        """norm: the global norm of the gradients the clip takes (default:
        theirs; a sharded trainer passes the norm over every shard)."""
        tc = self.tc
        norm = global_norm(grads) if norm is None else norm
        clip = not bool(norm < tc.grad_clip)
        count = state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        count += 1
        # 1 - decay**count in f32, then cast to each leaf's dtype
        bc1 = 1.0 - torch.tensor(tc.b1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(tc.b2, dtype=torch.float32) ** count
        for g, p, mu, nu in zip(grads, params, tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            if clip:
                g = (g / norm.to(g.dtype)) * tc.grad_clip
            mu.mul_(tc.b1).add_((1 - tc.b1) * g)
            nu.mul_(tc.b2).add_((1 - tc.b2) * (g * g))
            mu_hat = mu / bc1.to(mu.dtype).to(mu.device)
            nu_hat = nu / bc2.to(nu.dtype).to(nu.device)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + tc.weight_decay * p
            p.add_(u * -lr)
        state["count"] = count


# ---- hot-path spans -----------------------------------------------------------

def profiler_range(op: str, args: dict):
    """trace.hot's mirror: a torch.profiler range named `op` with `args` as
    its keyword inputs (lists joined with commas), opened only while a
    profiler runs, so it lands on the profiler's clock beside the kernels
    the span launches. The profiler keeps keyword inputs under
    record_shapes; record_function would drop an args string and costs
    several times as much a call."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return trace.NO_SPAN
    kw = {k: ",".join(map(str, v)) if isinstance(v, (list, tuple)) else v
          for k, v in args.items()}
    return torch._C._profiler._RecordFunctionFast(op, (), kw)


trace.register_hot_mirror(profiler_range)


# ---- loss -------------------------------------------------------------------

def loss_fn(params, tokens, config, impl: str = "auto_grad", sp=None,
            n_microbatches: int = 0, remat: bool = True,
            remat_policy: str = "dots", fsdp=None, row_shards: int = 1,
            tp=None, ep=None, data=None, groups=None,
            virtual_stages: int = 1):
    """Next-token CE in f32 (+ the family's extra loss). tokens [B, S];
    predicts tokens[:, 1:].

    Over ranks, the value is this rank's share of the global mean: the
    log-likelihood sum of its tokens over the global count, B * row_shards
    * (S - 1), where tokens are this rank's rows of the global batch (one
    of `row_shards`, dp x fsdp x ep) and, under an `sp` group
    (parallel.comm.AxisGroup), all their positions, of which the rank runs
    its S/sp. A shard's last position predicts the next shard's first
    token; the global last position predicts nothing. The shares sum to
    the loss. `fsdp`, `tp`, `ep`: the groups params are sharded over;
    under `tp` the logits are vocab shards and the cross-entropy is taken
    over the group, so every tp rank holds the same share. MoE routes over
    `data` (every axis but tp) and adds this rank's share of the router
    loss. n_microbatches > 0 selects the pipelined trunk
    (pipeline.pipeline_loss over `groups`, the plan's MeshGroups; the
    layers stored grouped when virtual_stages > 1)."""
    if n_microbatches:
        return pipeline_loss(params, tokens, config, groups,
                             n_microbatches=n_microbatches, impl=impl,
                             remat=remat, virtual_stages=virtual_stages,
                             pregrouped=virtual_stages > 1)
    fam = family_for(config)
    remat_policy = remat_policy if remat else "none"
    kw = dict(impl=impl, sp=sp, fsdp=fsdp, remat=remat_policy, tp=tp)
    if fam.returns_extra_loss:
        kw.update(ep=ep, data=data)
    if not sharded(sp) and row_shards == 1:
        out = fam.forward(params, tokens, config, **kw)            # f32
        logits, extra = out if fam.returns_extra_loss else (out, 0.0)
        return (-_log_likelihood(logits[:, :-1], tokens[:, 1:], tp).mean()
                + extra)
    b, s = tokens.shape
    n_sp, sp_rank = (sp.size, sp.rank) if sharded(sp) else (1, 0)
    if s % n_sp:
        raise ValueError(f"seq {s} does not shard over sp {n_sp}")
    s_loc = s // n_sp
    lo = sp_rank * s_loc
    out = fam.forward(params, tokens[:, lo:lo + s_loc], config, **kw)
    logits, extra = out if fam.returns_extra_loss else (out, 0.0)
    return _ce_share(logits, tokens, sp, tp, row_shards) + extra


def _ce_share(logits, tokens, sp, tp, row_shards: int) -> torch.Tensor:
    """This rank's share of the global mean CE: the log-likelihood sum of
    its logits [B, S/sp, V(/tp)] (its rows, its sequence shard of
    `tokens` [B, S]) over the global count B * row_shards * (S - 1). A
    shard's last position predicts the next shard's first token; the
    global last position predicts nothing."""
    b, s = tokens.shape
    s_loc = logits.shape[1]
    lo = sp.rank * s_loc if sharded(sp) else 0
    targets = tokens[:, lo + 1:lo + s_loc + 1]      # one short on the last
    ll = _log_likelihood(logits[:, :targets.shape[1]], targets, tp)
    return -ll.sum() / (b * row_shards * (s - 1))


def _log_likelihood(logits, targets, tp=None):
    """[B, T, V] f32 logits, [B, T] targets -> [B, T] log-probabilities.
    Under a `tp` group the logits are this rank's vocab chunk [B, T, V/tp]
    (vocab-parallel cross-entropy): the row max over the group (no
    gradient), the sum of exps over the group, and the target's logit
    from the rank whose chunk holds it, summed over the group; every rank
    gets the same values, the one-rank log_softmax's."""
    if not sharded(tp):
        logp = F.log_softmax(logits, dim=-1)
        return logp.gather(-1, targets[..., None].long())[..., 0]
    n = logits.shape[-1]
    with torch.no_grad():
        top = logits.max(dim=-1, keepdim=True).values
        comm.all_reduce_max([top], tp)
    shifted = logits - top
    sum_exp = comm.reduce_from_group(shifted.exp().sum(dim=-1), tp)
    local = targets.long() - tp.rank * n
    outside = (local < 0) | (local >= n)
    picked = shifted.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = comm.reduce_from_group(picked.masked_fill(outside, 0), tp)
    return picked - torch.log(sum_exp)


# ---- trainer ----------------------------------------------------------------

def _grad(loss: torch.Tensor, leaves: list) -> tuple:
    """The gradient of `loss` for each leaf, zeros for a leaf this rank
    does not use (under pp, embed off the first stage and the head off
    the last)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def param_specs(config, pipelined: bool = False,
                virtual_stages: int = 1) -> dict:
    """The sharding spec tree of the train state's parameters
    (param_sharding_rules by param_kinds). The stacked layers' leading [L]
    dim is cut over pp when the trunk is pipelined, else whole; under the
    interleaved schedule (virtual_stages > 1) the layers are stored
    grouped, [v, pp, L/(v*pp), ...] (pipeline.group_layers), cut over pp
    on the pp dim."""
    rules = param_sharding_rules()
    kinds = family_for(config).param_kinds(config)
    if pipelined and virtual_stages > 1:
        lead = (None, "pp", None)
    else:
        lead = ("pp" if pipelined else None,)
    return {
        "embed": rules[kinds["embed"]],
        "layers": {k: (*lead, *rules[v]) for k, v in kinds["layers"].items()},
        "final_norm": rules[kinds["final_norm"]],
        "lm_head": rules[kinds["lm_head"]],
    }


def state_shapes(config, pp: int = 1, virtual_stages: int = 1) -> dict:
    """{name: (shape, dtype)} of the train state's parameters: the
    family's, with the layers grouped [v, pp, L/(v*pp), ...] under the
    interleaved schedule (pp > 1 and virtual_stages > 1)."""
    shapes = param_shapes(config)
    if pp > 1 and virtual_stages > 1:
        def grouped(sd):
            shape, dtype = sd
            lc = shape[0] // (virtual_stages * pp)
            return (virtual_stages, pp, lc, *shape[1:]), dtype
        shapes = {**shapes, "layers": {k: grouped(v) for k, v in
                                       shapes["layers"].items()}}
    return shapes


@dataclass
class Trainer:
    """Owns the train step on one device, or on this rank of a plan over
    dp, fsdp, pp, ep, tp and sp.

    Usage:
        trainer = Trainer.create(config)            # on the card
        state = trainer.init(seed=0)
        state, metrics = trainer.step(state, trainer.shard_batch(tokens))

    Over ranks: Trainer.create(config, plan, groups=MeshGroups.build(plan))
    on every rank, each with the same global batch to shard_batch."""
    config: Any
    tc: TrainConfig
    device: torch.device
    plan: MeshPlan
    optimizer: AdamW
    groups: Optional[MeshGroups] = None

    @classmethod
    def create(cls, config, plan: Optional[MeshPlan] = None,
               tc: Optional[TrainConfig] = None, device=None,
               groups: Optional[MeshGroups] = None) -> "Trainer":
        """device: None or "cuda" = the card (raises without one); "cpu"
        only when asked for. groups: this rank's groups of the plan, which
        a plan over more than one rank needs."""
        plan = plan or (groups.plan if groups else MeshPlan())
        if plan.size > 1 and (groups is None or groups.plan != plan):
            raise ValueError(f"{plan} needs the groups of its {plan.size} "
                             f"ranks (MeshGroups.build), got {groups}")
        tc = tc or TrainConfig()
        # ill-formed pipeline layouts fail here, before any state exists
        if plan.pp > 1:
            v, m = tc.virtual_stages, tc.n_microbatches
            if (plan.sp > 1 and config.sp_attn == "ulysses"
                    and config.n_heads % plan.sp):
                raise ValueError(
                    f"Ulysses under pp needs n_heads {config.n_heads} "
                    f"divisible by sp {plan.sp}")
            # the layers over pp * v, the microbatches over pp when
            # interleaved (the batch is checked at the step)
            _check_divisible((config.n_layers,), m, plan.pp, m, v)
        trainer = cls(config=config, tc=tc, device=resolve_device(device),
                      plan=plan, optimizer=AdamW(tc),
                      groups=groups if plan.size > 1 else None)
        # an uneven shard fails here too
        shard_params(tree_map(lambda sd: torch.empty(
            sd[0], dtype=sd[1], device="meta"), trainer._shapes()),
            trainer._specs(), plan, 0)
        return trainer

    # ---- the layout ----

    @property
    def pipelined(self) -> bool:
        return self.plan.pp > 1

    def _specs(self) -> dict:
        return param_specs(self.config, self.pipelined,
                           self.tc.virtual_stages)

    def _shapes(self) -> dict:
        return state_shapes(self.config, self.plan.pp,
                            self.tc.virtual_stages)

    def _layout(self, params: dict) -> dict:
        """Whole canonical parameters in the state's layout (grouped under
        the interleaved schedule)."""
        if not (self.pipelined and self.tc.virtual_stages > 1):
            return params
        return {**params, "layers": group_layers(
            params["layers"], self.plan.pp, self.tc.virtual_stages)}

    @property
    def sp(self) -> Optional[comm.AxisGroup]:
        return self.groups.sp if self.groups else None

    @property
    def fsdp(self) -> Optional[comm.AxisGroup]:
        return self.groups.fsdp if self.groups else None

    @property
    def tp(self) -> Optional[comm.AxisGroup]:
        return self.groups.tp if self.groups else None

    @property
    def ep(self) -> Optional[comm.AxisGroup]:
        return self.groups.ep if self.groups else None

    @property
    def data(self) -> Optional[comm.AxisGroup]:
        return self.groups.data if self.groups else None

    @property
    def rank(self) -> int:
        return self.groups.rank if self.groups else 0

    @property
    def dims(self) -> dict:
        """((axis, the dim it cuts), ...) of each leaf of the state's
        parameter tree, in PARAM_AXES order (split_dims; (): whole on
        every rank)."""
        return tree_map(lambda spec: split_dims(spec, self.plan),
                        self._specs())

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        """An owned, contiguous copy on the trainer's device."""
        return t.to(self.device, memory_format=torch.contiguous_format,
                    copy=True)

    def _shard_tree(self, tree: dict) -> dict:
        """This rank's shards of a whole parameter-shaped tree
        (shard_params), owned copies on the trainer's device."""
        return tree_map(self._own, shard_params(
            tree, self._specs(), self.plan, self.rank))

    # ---- state ----

    def init(self, seed: int = 0) -> dict:
        """A fresh train state around init_params(seed)."""
        return self._fresh(self.init_params(seed))

    def init_params(self, seed: int = 0) -> dict:
        """Fresh parameters from `seed` (no optimizer state: what a
        serving rank holds), drawn leaf by leaf as the one-rank init
        draws them (so every rank draws rank 0's values); each rank keeps
        its shard of a leaf as soon as it is drawn, so no rank holds more
        than one whole leaf at a time."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def leaf(path, shape_dtype, spec, held):
            name = path.rsplit(".", 1)[-1]
            whole = init_from_shapes({name: shape_dtype}, gen)[name]
            whole = whole.reshape(held[0])  # grouped, under interleaving
            return self._own(shard(whole, spec, self.plan, self.rank, path))
        return tree_map_named(leaf, param_shapes(self.config),
                              self._specs(), self._shapes())

    def state_from_params(self, params: dict) -> dict:
        """A fresh train state around whole canonical parameters (e.g.
        converted from the JAX package, convert.py): this rank's shards of
        them, in the state's layout."""
        return self._fresh(self._shard_tree(self._layout(params)))

    def _fresh(self, params: dict) -> dict:
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def shard_state(self, state: dict) -> dict:
        """This rank's shards of a whole train state (a checkpoint's, in the
        state's layout): the parameters and AdamW's mu and nu sharded
        alike, count and step as they are."""
        opt = state["opt_state"]
        params = self._shard_tree(state["params"])
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return {"params": params,
                "opt_state": {"count": opt["count"],
                              "mu": self._shard_tree(opt["mu"]),
                              "nu": self._shard_tree(opt["nu"])},
                "step": state["step"]}

    def full_state(self, state: dict) -> Optional[dict]:
        """The whole train state, what a checkpoint holds: on the world's
        rank 0 the parameters, mu and nu gathered leaf by leaf to the host
        (the state itself on one rank and without fsdp, pp, tp or ep; the
        layers grouped under the interleaved schedule); None on the other
        ranks. Collective: every rank calls it."""
        writer = self.rank == 0
        if all(getattr(self.plan, a) == 1 for a in PARAM_AXES):
            return state if writer else None

        def whole(t, dims):
            for axis, dim in dims:      # fsdp, the minor axis, first
                t = comm.gather_leaf(t, dim, getattr(self.groups, axis))
            return t.detach().cpu() if writer else None

        def tree(t):
            return tree_map_named(lambda _, x, dims: whole(x, dims), t,
                                  self.dims)
        opt = state["opt_state"]
        out = {"params": tree(state["params"]),
               "opt_state": {"count": opt["count"], "mu": tree(opt["mu"]),
                             "nu": tree(opt["nu"])},
               "step": state["step"]}
        return out if writer else None

    def abstract_state(self) -> dict:
        """Shapes and dtypes of the whole parameters in the state's layout,
        without allocating: the template a restored checkpoint is checked
        against (so a grouped checkpoint restores only under its pp and
        v)."""
        return {"params": self._shapes()}

    # ---- the step ----

    def _loss(self, params, tokens):
        return loss_fn(params, tokens, self.config, sp=self.sp,
                       fsdp=self.fsdp, tp=self.tp, ep=self.ep, data=self.data,
                       row_shards=self.groups.rows[1] if self.groups else 1,
                       remat=self.tc.remat,
                       remat_policy=self.tc.remat_policy,
                       n_microbatches=(self.tc.n_microbatches
                                       if self.pipelined else 0),
                       groups=self.groups,
                       virtual_stages=self.tc.virtual_stages)

    def step(self, state: dict, tokens: torch.Tensor):
        """One optimizer step, in place on `state`. Returns (state,
        {"loss", "grad_norm"}), grad_norm taken before the clip. Over ranks
        every rank calls it with its shard_batch of the same global batch
        and gets the global loss and grad_norm. Under accumulation micro-
        slice i is the i-th accum-th of `tokens` (shard_batch's order)."""
        with trace.hot("train.step", step=state["step"]):
            return self._step(state, tokens)

    def _step(self, state: dict, tokens: torch.Tensor):
        """step() inside its train.step span: train.forward, then
        train.backward (each micro-slice's under accumulation), then
        train.grad_norm and train.optimizer."""
        params = state["params"]
        leaves = tree_leaves(params)
        accum = max(self.tc.accum_steps, 1)
        if accum == 1:
            with trace.hot("train.forward"):
                loss = self._loss(params, tokens)
            with trace.hot("train.backward"):
                grads = _grad(loss, leaves)
            loss = loss.detach()
        else:
            b = tokens.shape[0]
            if b % accum:
                raise ValueError(
                    f"batch {b} not divisible by accum_steps {accum}")
            grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i, toks in enumerate(
                    tokens.reshape(accum, b // accum, *tokens.shape[1:])):
                with trace.hot("train.forward", micro=i):
                    part = self._loss(params, toks)
                with trace.hot("train.backward", micro=i):
                    # sum in f32: adding bf16 micro-grads would bleed
                    # precision
                    for acc, g in zip(grad_sum, _grad(part, leaves)):
                        acc.add_(g.float())
                loss += part.detach()
            loss = loss / accum
            grads = [(g / accum).to(p.dtype) for g, p in zip(grad_sum, leaves)]
        # each leaf's split dims, in the order of `leaves`
        dims = tree_leaves(tree_map_named(lambda _, p, d: d, params,
                                          self.dims))
        with trace.hot("train.grad_norm"):
            gnorm = self._sum_over_ranks(grads, dims, loss)
        with trace.hot("train.optimizer"):
            self.optimizer.update(grads, state["opt_state"], leaves, gnorm)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    def _sum_over_ranks(self, grads: list, dims: list, loss: torch.Tensor
                        ) -> torch.Tensor:
        """Each rank's gradients and loss are partial sums: add them up in
        place, in f32, each leaf's over the ranks that hold the same shard
        (MeshGroups.sum_group of the axes that cut it, the reduce-scatter
        over fsdp being done): dp x ep x sp for a matrix, dp x sp for a bank
        cut over ep, every axis but tp for a whole leaf (whose tp ranks each
        hold all of it), pp too for a leaf that is not a stage's; the loss
        over every axis but tp (`data`). Returns the global norm of the
        gradients: each leaf's squares summed over the axes that cut it,
        so each shard counts once and each whole leaf once."""
        g = self.groups
        if g is None:
            return global_norm(grads)
        cuts = [tuple(a for a, _ in d) for d in dims]
        by_cut: dict = {(): [loss]}
        for x, cut in zip(grads, cuts):
            by_cut.setdefault(tuple(a for a in cut if a != "tp"), []).append(x)
        for cut in sorted(by_cut):
            group = g.sum_group(cut)
            if group is not None:
                comm.all_reduce_sum(by_cut[cut], group)
        squares: dict = {}
        for x, cut in zip(grads, cuts):        # of the summed gradients
            squares[cut] = squares.get(cut, 0.0) + sum_squares([x])
        cuts = sorted(squares)
        total = torch.stack([squares[c] for c in cuts])
        for axis in PARAM_AXES:
            group = getattr(g, axis)
            rows = [i for i, c in enumerate(cuts) if axis in c]
            if group is not None and rows:
                part = total[rows]
                comm.all_reduce_sum([part], group)
                total[rows] = part
        return torch.sqrt(total.sum())

    def shard_batch(self, tokens) -> torch.Tensor:
        """This rank's rows of a host batch [B, S], onto the trainer's
        device: the rows shard over dp x fsdp x ep (all of them on one
        rank; the pp ranks of a row shard take the same rows). B must
        divide, as the JAX batch sharding requires. Under accum_steps a
        the rank takes its 1/n of each of the a global micro-slices (rows
        [i*B/a, (i+1)*B/a)), in order, so its i-th micro-slice is its rows
        of JAX's i-th; under pp, of each of the M pipeline microbatches of
        each micro-slice, so MoE routes each microbatch as JAX does."""
        if self.groups is not None:
            i, n = self.groups.rows
            b = tokens.shape[0]
            a = max(self.tc.accum_steps, 1)
            m = self.tc.n_microbatches if self.pipelined else 1
            if b % (n * a * m):
                raise ValueError(
                    f"batch {b} does not divide over dp x fsdp x ep = {n} "
                    f"row shards" + (f" x accum_steps {a}" if a > 1 else "")
                    + (f" x n_microbatches {m}" if m > 1 else ""))
            k = b // (a * m)
            lo = [j * k + i * k // n for j in range(a * m)]
            tokens = tokens[[r for x in lo for r in range(x, x + k // n)]]
        return to_device(tokens, self.device)


# ---- checkpointing (torch.save, one directory per step) ----------------------
#
# <path>/<step>/state.pt is written under <path>/<step>.tmp-<pid>/, fsync'd,
# renamed into place and the parent directory fsync'd: a step directory
# exists only once its state is durable. A crash mid-save leaves only a
# *.tmp-* directory, which the resume path sweeps first.

STATE_FILE = "state.pt"
TMP_MARK = ".tmp-"


def save_checkpoint(path: str, state: dict, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
    tmp = os.path.join(path, f"{step}{TMP_MARK}{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):       # an earlier save of this same step
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(path)


def purge_incomplete_checkpoints(path: str) -> int:
    """Remove uncommitted step directories (*.tmp-*), the debris a kill
    lands mid-save. Returns how many were removed."""
    try:
        entries = os.listdir(path)
    except OSError:
        return 0
    n = 0
    for entry in entries:
        if TMP_MARK in entry:
            shutil.rmtree(os.path.join(path, entry), ignore_errors=True)
            n += 1
    return n


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under `path`, or None."""
    try:
        entries = os.listdir(path)
    except OSError:
        return None
    steps = [int(e) for e in entries if e.isdigit()
             and os.path.exists(os.path.join(path, e, STATE_FILE))]
    return max(steps, default=None)


def check_template(params: dict, shapes: dict, path: str = "") -> None:
    """Raises ValueError unless params ({name: tensor}, nested) has the
    keys, shapes and dtypes of `shapes` ({name: (shape, dtype)})."""
    if set(params) != set(shapes):
        raise ValueError(f"checkpoint {path or 'params'} keys "
                         f"{sorted(params)} != {sorted(shapes)}")
    for name, spec in shapes.items():
        if isinstance(spec, dict):
            check_template(params[name], spec, f"{path}{name}.")
        elif (tuple(params[name].shape), params[name].dtype) != spec:
            raise ValueError(
                f"checkpoint {path}{name}: {tuple(params[name].shape)} "
                f"{params[name].dtype} != {spec[0]} {spec[1]}")


def restore_checkpoint(path: str, abstract_state: Optional[dict] = None,
                       device="cpu") -> tuple[dict, int]:
    """(state, step) of the newest committed checkpoint, loaded onto
    `device`. FileNotFoundError when there is none; a checkpoint whose
    parameters do not match `abstract_state` raises ValueError."""
    purge_incomplete_checkpoints(path)
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    # mmap: a rank that keeps shards of a large state reads only their
    # pages, not the whole file
    state = torch.load(os.path.join(path, str(step), STATE_FILE),
                       map_location=device, weights_only=True, mmap=True)
    if abstract_state is not None:
        check_template(state["params"], abstract_state["params"])
    for p in tree_leaves(state["params"]):
        p.requires_grad_(True)
    return state, step


# ---- workload quiesce (checkpoint-on-drain) ----------------------------------
#
# The workload half of the backend quiesce contract (Backend.quiesce): on
# SIGUSR1 the workload finishes its in-flight step, saves a checkpoint at that
# exact step, writes a durable `QUIESCED <step>` marker next to it, writes the
# `.quiesced` ack the backend polls for, and parks until the control plane
# stops it. Byte-compatible with gpu_docker_api_tpu/train.py.

QUIESCE_MARKER = "QUIESCED"


class QuiesceSignal:
    """Installs the SIGUSR1 handler; the training loop polls `requested` at
    step boundaries (the handler only flips a flag)."""

    def __init__(self):
        import signal
        self.requested = False
        signal.signal(signal.SIGUSR1, self._on_signal)

    def _on_signal(self, signum, frame):
        self.requested = True

    @staticmethod
    def park() -> None:
        """Hold the process alive until the control plane's stop (SIGTERM).
        A short sleep and not signal.pause(): a stop that lands just before
        the pause, or on another thread, would leave pause() blocked until
        the stop's SIGKILL; after a sleep the main thread runs the handler."""
        import time
        while True:
            time.sleep(0.05)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _durable_write(path: str, payload: str) -> None:
    """Atomic + durable: tmp-write, fsync, rename, fsync dir."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def write_quiesce_marker(ckpt_dir: str, step: int) -> None:
    """Durable `QUIESCED <step>` next to the checkpoints, written after the
    checkpoint is durable, so marker implies checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _durable_write(os.path.join(ckpt_dir, QUIESCE_MARKER), f"{step}\n")


def read_quiesce_marker(ckpt_dir: str):
    """The parked step, or None when no quiesce marker exists."""
    try:
        with open(os.path.join(ckpt_dir, QUIESCE_MARKER)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def clear_quiesce_marker(ckpt_dir: str) -> None:
    """Consume the marker on resume (idempotent)."""
    try:
        os.unlink(os.path.join(ckpt_dir, QUIESCE_MARKER))
    except OSError:
        return
    _fsync_dir(ckpt_dir)


def write_quiesce_ack(step: int) -> None:
    """The ack the backend polls for at the container's writable-layer root,
    written last: it is the 'safe to stop me' promise."""
    root = os.environ.get("CONTAINER_ROOT") or os.getcwd()
    _durable_write(os.path.join(root, ".quiesced"),
                   json.dumps({"step": step}))
