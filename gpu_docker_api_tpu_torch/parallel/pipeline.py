"""Pipeline parallelism over the `pp` axis: GPipe and interleaved
(virtual-stage) schedules. PyTorch port of
gpu_docker_api_tpu/parallel/pipeline.py.

The decoder trunk is split into stages: the stacked layer leaves are cut
over pp (train.param_specs), and each pp rank runs only its own stage's
layers. Microbatches flow stage to stage round the pp ring, one hop a
tick (comm.ring_shift: rank -> rank + 1, differentiable, its backward the
reverse hop).

The schedule is JAX's, tick for tick. With v virtual stages (v = 1:
GPipe) each stage holds v layer chunks (stage d owns the global chunks
{l * pp + d, l < v}, group_layers) and every microbatch rides the ring v
laps. At tick t stage d has phase tau = t - d and works on

    lap   l  = (tau // pp) mod v          (which local chunk)
    micro mb = (tau // (pp*v))*pp + tau%pp  (which microbatch)

while 0 <= tau < M*v; stage 0 injects on lap 0, the last stage banks each
microbatch's final lap, and what stage d - 1 made at tick t - 1 is what
stage d consumes at t. Ticks = M*v + pp - 1 (schedule_work_units).

JAX's SPMD scan runs every stage on every tick, bubbles on zeros; here a
bubble tick skips the compute but still takes part in the hop (it sends
zeros), so every rank of a pp group runs the same hops forward and
backward. A bubble depends on the pp index alone, so the fsdp, tp, ep and
sp groups of one stage share it and their collectives stay in step. The
last tick's hop is not made: nothing consumes it. Each tick's input is
tied (comm.tie_hops) to what the ring delivered, used or not, and the
last tick's output to the trunk's aux scalar, which every rank adds to
its loss: so the hops' backward runs on every rank, in reverse tick
order, each after the stage compute that consumed its output.

Remat is per stage, as jax.checkpoint(stage): the stage keeps its input
and reruns its layers (and their fsdp/tp/ep/sp collectives) in the
backward.

Embedding runs on stage 0 and the head (final norm, lm_head, the loss) on
the last stage, so their parameters get gradients there alone; the
trainer sums those over pp (JAX keeps them whole over pp).

MoE: each layer routes its microbatch's tokens over `routes` (dp x fsdp x
ep: the rows of one microbatch), and under pp x sp each sequence shard
routes its own (JAX's pools: per microbatch, and per sequence shard). The
router loss is summed over the real chunk visits and divided by M (M * sp
under sp); each rank holds its share, and the shares sum over every axis
but tp to JAX's psum'd value. microbatched_forward is the plain version on
one rank: the microbatches one after another through all layers, with
the same pools.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..models import family_for, moe
from ..models.llama import (
    _attention_block, embed_tokens, head_logits, layer_body,
    rope_frequencies, shard_positions, sharded,
)
from ..models.remat import remat_wrap
from . import comm
from .mesh import MeshGroups, MeshPlan


def schedule_work_units(pp: int, m: int, v: int = 1) -> float:
    """Per-stage work of one pipelined step, in units of a FULL network
    pass (L layers) on one microbatch: ticks x per-tick depth. The useful
    work is m/pp; everything above it is bubble."""
    ticks = m * v + pp - 1
    return ticks / (v * pp)


def group_layers(layers: dict, pp: int, v: int) -> dict:
    """[L, ...] -> [v, pp, L/(v*pp), ...]: global layer (l*pp + d)*Lc + j
    lands at [l, d, j], so stage d's chunks are exactly {l*pp + d}. A
    trainer under the interleaved schedule stores its layers in this
    layout (cut over pp on dim 1)."""
    def g(a):
        n = a.shape[0]
        if n % (v * pp):
            raise ValueError(
                f"n_layers {n} not divisible by pp*virtual_stages {pp}*{v}")
        return a.reshape(v, pp, n // (v * pp), *a.shape[1:])
    return {k: g(a) for k, a in layers.items()}


def ungroup_layers(layers: dict, pp: int, v: int) -> dict:
    """Inverse of group_layers, back to the canonical [L, ...] stack (to
    serve a checkpoint an interleaved trainer saved)."""
    def u(a):
        if tuple(a.shape[:2]) != (v, pp):
            raise ValueError(
                f"layer leaf leads with {tuple(a.shape[:3])}, expected "
                f"(v={v}, pp={pp}, Lc) — not a group_layers layout")
        return a.reshape(a.shape[0] * a.shape[1] * a.shape[2], *a.shape[3:])
    return {k: u(a) for k, a in layers.items()}


def _check_divisible(lead: tuple, b: int, npp: int, m: int, v: int = 1,
                     pregrouped: bool = False) -> None:
    """JAX's errors up front. lead: the leading dims of the whole stacked
    layer leaves ([L] or, pregrouped, [v, pp, Lc]); b: the global batch."""
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if pregrouped:
        if tuple(lead[:2]) != (v, npp):
            raise ValueError(
                f"pregrouped layers lead with {tuple(lead[:3])}, "
                f"expected (v={v}, pp={npp}, Lc)")
    else:
        n_layers = lead[0]
        if n_layers % (npp * v) != 0:
            raise ValueError(
                f"n_layers {n_layers} not divisible by pp*virtual_stages "
                f"{npp}*{v} — each pipeline chunk must hold the same number "
                f"of layers")
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by n_microbatches {m}")
    if v > 1 and m % npp != 0:
        raise ValueError(
            f"interleaved schedule injects microbatches in groups of pp: "
            f"n_microbatches {m} must be divisible by pp {npp}")


def schedule(npp: int, m: int, v: int, stage: int) -> list:
    """Stage `stage`'s work at each of the M*v + pp - 1 ticks of a step:
    (lap, microbatch), or None on a bubble tick."""
    out = []
    for t in range(m * v + npp - 1):
        tau = t - stage
        if 0 <= tau < m * v:
            k = tau // npp
            out.append((k % v, (k // v) * npp + tau % npp))
        else:
            out.append(None)
    return out


def stage_chunks(layers: dict, pp, v: int, pregrouped: bool) -> dict:
    """This stage's chunks {name: [v, Lc, ...]} from the rank's layer
    leaves: pregrouped, its shard of the [v, pp, Lc, ...] layout; else its
    shard of the canonical [L, ...] stack cut over pp, which under v > 1
    is gathered whole over pp first and regrouped (differentiable: the
    gradient goes back reduce-scattered), as JAX regroups canonical stacks
    inside. Without a pp group the leaves are the whole stack."""
    if pregrouped:
        return {k: a[:, 0] for k, a in layers.items()}
    if v == 1:
        return {k: a[None] for k, a in layers.items()}
    keys = list(layers)
    whole = comm.all_gather([layers[k] for k in keys], [0] * len(keys), pp)
    grouped = group_layers(dict(zip(keys, whole)), pp.size, v)
    return {k: a[:, pp.rank] for k, a in grouped.items()}


def pipeline_trunk(chunks: dict, x: torch.Tensor, layer_fn: Callable, pp,
                   n_microbatches: int, remat: bool = True,
                   virtual_stages: int = 1, with_aux: bool = False,
                   seq_shards: int = 1):
    """Run `layer_fn` over this stage's `chunks` ({name: [v, Lc, ...]},
    stage_chunks) as one stage of a pp-stage pipeline.

    x: [b, S, D] this rank's activations (its rows, under sp its sequence
    shard); only stage 0 reads its values (a zero-stride tensor of the
    shape will do elsewhere). layer_fn(h, *weights) -> h, or (h, aux)
    with with_aux (the MoE router loss share, accumulated over real chunk
    visits only). Without a pp group (or at size 1) the layers run in
    order on the whole batch, as JAX's pp=1 scan.

    Returns (out, aux): out [b, S, D] on the last stage, its microbatches'
    outputs in order, None on the others; aux this rank's sum over its
    real visits divided by M * seq_shards, carrying the last tick's output
    (tie_hops). Every rank adds aux to its loss, so that every hop's
    backward runs."""
    keys = list(chunks)
    v = virtual_stages
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layers(h, *flat):
        aux = zero
        for i in range(0, len(flat), len(keys)):
            out = layer_fn(h, *flat[i:i + len(keys)])
            if with_aux:
                h, a = out
                aux = aux + a
            else:
                h = out
        return h, aux

    laps = [[w for weights in zip(*(chunks[k][lap].unbind(0) for k in keys))
             for w in weights] for lap in range(v)]
    if not sharded(pp):
        if v != 1:
            raise ValueError("virtual_stages > 1 needs a pp group")
        return run_layers(x, *laps[0])

    def run_stage(h, lap):
        if remat:
            return checkpoint(run_layers, h, *laps[lap], use_reentrant=False)
        return run_layers(h, *laps[lap])

    m, npp, stage = n_microbatches, pp.size, pp.rank
    b = x.shape[0]
    mb_shape = (b // m, *x.shape[1:])
    x_mb = x.reshape(m, *mb_shape)
    grad = torch.is_grad_enabled()
    # what the ring delivered; before the first tick, zeros
    recv = torch.zeros(mb_shape, dtype=x.dtype, device=x.device,
                       requires_grad=grad)
    # a bubble's zeros are tied to what the ring delivered and to the
    # stage's smallest weight: the backward computes only what leads to
    # the gradients asked for, and a hop whose input led nowhere would be
    # skipped here while its peer waits for it
    anchor = min(laps[0], key=lambda w: w.numel())
    banked = [None] * m
    aux = zero
    ticks = schedule(npp, m, v, stage)
    for t, work in enumerate(ticks):
        if work is None:                    # bubble: no compute, zeros on
            y = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
            y = comm.tie_hops(y, recv, anchor) if grad else y
        else:
            lap, mb = work
            h = recv
            if stage == 0 and lap == 0:     # a fresh microbatch
                h = comm.tie_hops(x_mb[mb], recv) if grad else x_mb[mb]
            y, a = run_stage(h, lap)
            aux = aux + a
            if stage == npp - 1 and lap == v - 1:
                banked[mb] = y
        if t < len(ticks) - 1:
            recv = comm.ring_shift(y, pp)
    if grad:
        aux = comm.tie_hops(aux, y)
    out = torch.cat(banked) if stage == npp - 1 else None
    return out, aux / (m * seq_shards)


def _layer_fn(config, groups, cos, sin, impl: str):
    """The stage's layer: llama's body, or MoE's with each layer's router
    loss share (weighted_router_loss), routed over `routes` and, under sp,
    each sequence shard on its own."""
    g = groups
    if not family_for(config).returns_extra_loss:
        return layer_body(config, cos, sin, impl, g.sp, g.fsdp, g.tp)
    body = moe.layer_body(config, cos, sin, impl, g.sp, g.fsdp, g.tp, g.ep,
                          g.routes, shard_pools=True)

    def layer(h, *weights):
        h, aux, z = body(h, *weights)
        return h, moe.weighted_router_loss(aux, z, config)
    return layer


def _pipelined(params: dict, tokens: torch.Tensor, config, groups,
               n_microbatches: int, impl: str, remat: bool,
               virtual_stages: int, pregrouped: bool):
    """(the trunk's output on the last stage, else None; the aux share)
    of this rank's rows `tokens` [b, S] (under sp its shard of them)."""
    c = config
    plan = groups.plan
    n_sp, npp, v = plan.sp, plan.pp, virtual_stages
    if n_sp > 1 and npp == 1:
        raise ValueError(
            "mesh has sp>1 but pp=1 — use the non-pipelined forward "
            "(loss_fn without microbatches / llama_forward), which runs "
            "ring/ulysses sequence parallelism itself")
    if n_sp > 1 and c.sp_attn == "ulysses" and c.n_heads % n_sp:
        raise ValueError(
            f"Ulysses under pp needs n_heads {c.n_heads} divisible by "
            f"sp {n_sp}")
    b, s = tokens.shape
    if s % n_sp:
        raise ValueError(f"seq {s} not divisible by sp {n_sp}")
    if npp > 1:
        lead = next(iter(params["layers"].values())).shape
        lead = (v, npp, *lead[2:3]) if pregrouped else (lead[0] * npp,)
        _check_divisible(lead, b * groups.rows[1], npp, n_microbatches, v,
                         pregrouped)
        if b % n_microbatches:
            raise ValueError(f"this rank's {b} rows do not divide into "
                             f"n_microbatches {n_microbatches}")
    elif pregrouped:
        raise ValueError("pregrouped layers require a pp>1 mesh")
    s_loc = s // n_sp
    tokens = comm.local_shard(tokens, groups.sp)
    if groups.pp is None or groups.pp.rank == 0:
        x = embed_tokens(params, tokens, groups.fsdp, groups.tp)
    else:
        x = torch.zeros((), dtype=params["embed"].dtype,
                        device=tokens.device).expand(b, s_loc, c.d_model)
    lc = c.as_llama() if family_for(c).returns_extra_loss else c
    cos, sin = rope_frequencies(lc, shard_positions(s_loc, groups.sp,
                                                    tokens.device))
    chunks = stage_chunks(params["layers"], groups.pp, v, pregrouped)
    return pipeline_trunk(
        chunks, x, _layer_fn(c, groups, cos, sin, impl), groups.pp,
        n_microbatches, remat=remat, virtual_stages=v,
        with_aux=family_for(c).returns_extra_loss, seq_shards=n_sp)


def pipeline_forward(params: dict, tokens: torch.Tensor, config, groups,
                     n_microbatches: int = 4, impl: str = "auto",
                     remat: bool = True, virtual_stages: int = 1,
                     pregrouped: bool = False):
    """Llama-family forward with the trunk pipelined over `groups.pp`
    (parallel.mesh.MeshGroups, the mesh's place). params: this rank's
    shards under train.param_specs(config, pipelined=True,
    virtual_stages), the layers pregrouped ([v, pp, Lc, ...], what an
    interleaved trainer stores) or canonical ([L, ...]); tokens: this
    rank's rows [b, S] (shard_batch's), whole sequence.

    Returns on the last stage the logits [b, S/sp, V/tp] of its rows and
    sequence shard, f32, None on the other stages; MoE configs return
    (logits, router_loss), the router loss the same on every rank (JAX's
    psum over pp; per-microbatch, and under sp per-sequence-shard,
    routing pools). Every rank of the plan calls together; groups None:
    one rank."""
    groups = groups or MeshGroups(MeshPlan(), 0)
    out, aux = _pipelined(params, tokens, config, groups, n_microbatches,
                          impl, remat, virtual_stages, pregrouped)
    logits = (None if out is None
              else head_logits(params, out, config, groups.fsdp, groups.tp))
    if not family_for(config).returns_extra_loss:
        return logits
    router = aux.detach().clone()
    if groups.data is not None:
        comm.all_reduce_sum([router], groups.data)
    return logits, router


def pipeline_loss(params: dict, tokens: torch.Tensor, config, groups,
                  n_microbatches: int = 4, impl: str = "auto_grad",
                  remat: bool = True, virtual_stages: int = 1,
                  pregrouped: bool = False) -> torch.Tensor:
    """Next-token CE in f32 with the trunk pipelined (+ MoE's router
    loss): the training entry. As train.loss_fn, the value is this rank's
    share of the global loss, and the shares sum over every axis but tp:
    the last stage's log-likelihood sum over the global count (under sp a
    shard's last position predicts the next shard's first token), and on
    every rank its router-loss share and the ring's tie (aux)."""
    from ..train import _ce_share
    groups = groups or MeshGroups(MeshPlan(), 0)
    out, aux = _pipelined(params, tokens, config, groups, n_microbatches,
                          impl, remat, virtual_stages, pregrouped)
    if out is None:
        return aux
    logits = head_logits(params, out, config, groups.fsdp, groups.tp)
    return aux + _ce_share(logits, tokens, groups.sp, groups.tp,
                           groups.rows[1])


# ---- the plain version ------------------------------------------------------

def microbatched_forward(params: dict, tokens: torch.Tensor, config,
                         n_microbatches: int, seq_pools: int = 1,
                         impl: str = "auto", remat: str = "none"):
    """The plain version of pipeline_forward on one rank, whole params:
    the M microbatches one after another through all layers. MoE routes
    each (microbatch, one of `seq_pools` sequence chunks) on its own, the
    pools of a pipeline under sp = seq_pools, and its router loss is the
    sum over layers and pools divided by M * seq_pools. remat: a
    models/remat.py policy per layer. -> logits [B, S, V] f32 (MoE:
    (logits, router_loss))."""
    c = config
    fam = family_for(c)
    moe_family = fam.returns_extra_loss
    lc = c.as_llama() if moe_family else c
    b, s = tokens.shape
    if b % n_microbatches or s % seq_pools:
        raise ValueError(f"batch {b} / seq {s} do not divide into "
                         f"{n_microbatches} microbatches / {seq_pools} "
                         f"pools")
    x = embed_tokens(params, tokens)
    cos, sin = rope_frequencies(lc, torch.arange(s, device=tokens.device))
    if moe_family:
        def body(h, *weights):
            layer = dict(zip(fam.layer_keys, weights))
            h = _attention_block(h, layer, lc, cos, sin, impl)
            outs, loss = [], 0.0
            for part in h.chunk(seq_pools, dim=1):
                out, aux, z = moe.moe_block(part, layer, c)
                outs.append(out)
                loss = loss + moe.weighted_router_loss(aux, z, c)
            return torch.cat(outs, dim=1), loss
    else:
        body = layer_body(c, cos, sin, impl)
    step = remat_wrap(body, remat)
    stacks = [params["layers"][k].unbind(0) for k in fam.layer_keys]
    outs = []
    router = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for h in x.chunk(n_microbatches):
        for weights in zip(*stacks):
            if moe_family:
                h, loss = step(h, *weights)
                router = router + loss
            else:
                h = step(h, *weights)
        outs.append(h)
    logits = head_logits(params, torch.cat(outs), c)
    if moe_family:
        return logits, router / (n_microbatches * seq_pools)
    return logits


def microbatched_loss(params: dict, tokens: torch.Tensor, config,
                      n_microbatches: int, seq_pools: int = 1,
                      impl: str = "auto_grad", remat: str = "none"
                      ) -> torch.Tensor:
    """pipeline_loss's value on one rank, by the plain version: the mean
    next-token CE of microbatched_forward's logits (+ the router loss)."""
    from ..train import _log_likelihood
    out = microbatched_forward(params, tokens, config, n_microbatches,
                               seq_pools, impl, remat)
    logits, extra = (out if family_for(config).returns_extra_loss
                     else (out, 0.0))
    return -_log_likelihood(logits[:, :-1], tokens[:, 1:]).mean() + extra
