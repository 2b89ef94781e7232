"""Rank bodies of the port's multi-rank tests (test_torch_ring.py,
test_torch_ulysses.py, test_torch_sp_train.py, test_torch_distributed.py,
test_torch_mesh.py, test_torch_fsdp_train.py, test_torch_tp.py,
test_torch_tp_train.py, test_torch_ep.py, test_torch_moe_ranks_train.py,
test_torch_pipeline.py, test_torch_pp_train.py).

gpu_docker_api_tpu_torch.distributed.launch spawns each rank afresh and
imports its target by module path, so the targets live here, in a module
that imports neither jax nor the JAX package: a rank pays for torch alone.
Inputs come in, and results go out, as torch.save files.
"""

from __future__ import annotations

import os

import torch

from gpu_docker_api_tpu_torch.parallel import comm, ring, ulysses


def _shard(x, sp):
    return comm.local_shard(torch.as_tensor(x), sp).contiguous()


def attention_cases(rank: int, world: int, case_path: str, out_dir: str):
    """Each case {name, fn: "ring"|"ulysses", q, k, v, do (global numpy),
    causal, window, impl}: this rank's output and q/k/v gradient shards,
    and the ring hops it made, saved to out_dir/rank<r>.pt."""
    sp = comm.SPGroup.of()
    hops = [0]
    start = ring.ring_shift_start

    def counted(*args):
        hops[0] += 1
        return start(*args)

    ring.ring_shift_start = counted
    results = {}
    for case in torch.load(case_path, weights_only=False):
        q, k, v = (_shard(case[x], sp).requires_grad_(True)
                   for x in ("q", "k", "v"))
        fn = (ring.ring_attention if case["fn"] == "ring"
              else ulysses.ulysses_attention)
        hops[0] = 0
        out = fn(q, k, v, sp, causal=case["causal"], impl=case["impl"],
                 window=case["window"])
        grads = torch.autograd.grad(out, (q, k, v), _shard(case["do"], sp))
        results[case["name"]] = {"out": out.detach(), "grads": grads,
                                 "hops": hops[0]}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def train_steps(rank: int, world: int, spec_path: str, out_dir: str):
    """spec {config (a port LlamaConfig or MoEConfig), params (numpy
    tree), batches [[B, S] numpy], runs: [{name, remat_policy, sp_attn,
    and optionally plan (MeshPlan fields; default sp over the world),
    accum_steps, train (more TrainConfig fields: n_microbatches,
    virtual_stages), fault (a key of FAULTS, planted for the run) and save
    (write the gathered state)}]}: for each run, a fresh Trainer over the
    plan's groups from the same params steps through the batches; its
    losses and grad norms (and, on rank 0, its gathered final params)
    saved to out_dir/rank<r>.pt. With save, rank 0 also writes the
    gathered state as the checkpoint out_dir/<name>-ckpt and every rank
    returns its parameter shards."""
    import dataclasses

    from gpu_docker_api_tpu_torch import convert
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer, TrainConfig

    spec = torch.load(spec_path, weights_only=False)
    results = {}
    for run in spec["runs"]:
        config = dataclasses.replace(spec["config"], sp_attn=run["sp_attn"])
        plan = MeshPlan(**run.get("plan", {"sp": world}))
        trainer = Trainer.create(
            config, plan, tc=TrainConfig(
                remat_policy=run["remat_policy"],
                accum_steps=run.get("accum_steps", 1),
                **run.get("train", {})),
            device="cpu", groups=MeshGroups.build(plan))
        state = trainer.state_from_params(
            convert.params_from_numpy(spec["params"], config))
        losses, norms = [], []
        planted = FAULTS.get(run.get("fault"))
        if planted:
            name, make = planted
            real = getattr(moe, name)
            setattr(moe, name, make(real))
        try:
            for toks in spec["batches"]:
                state, m = trainer.step(state, trainer.shard_batch(toks))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        finally:
            if planted:
                setattr(moe, name, real)
        full = trainer.full_state(state)
        results[run["name"]] = {
            "losses": losses, "grad_norms": norms,
            "params": (convert.params_to_numpy(full["params"])
                       if rank == 0 else None)}
        if run.get("save"):
            from gpu_docker_api_tpu_torch.train import (
                save_checkpoint, tree_map,
            )
            if rank == 0:
                save_checkpoint(os.path.join(out_dir, f"{run['name']}-ckpt"),
                                full, len(spec["batches"]))
            results[run["name"]]["shards"] = tree_map(
                lambda t: t.detach().clone(), state["params"])
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


# ---- planted routing faults (MoE over ranks) --------------------------------

def rank_local_route(real):
    """models/moe._route with this rank's capacity and prefix: the
    positions, keep and capacity of its tokens alone (the exchange still
    runs, so the ranks stay in step)."""
    def route(ht, router, config, data=None, rows=1, n_sp=1):
        out = list(real(ht, router, config, data, rows, n_sp))
        out[5:8] = real(ht, router, config)[5:8]
        return tuple(out)
    return route


def rank_major_place(oh, within, every, rank, n_sp):
    """models/moe.place_blocks with the blocks in rank order within each
    k: all of rank 0's tokens, then rank 1's (wrong under sp, where a
    rank's tokens interleave with its sequence peers')."""
    k, rows, e, s_loc = oh.shape
    flat = every.permute(1, 0, 2, 3).reshape(-1, e).long()    # (k, rank, row)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(
        k, every.shape[0], rows, e)
    pos = (within + before[:, rank][..., None]) * oh
    pos = pos.sum(dim=2).permute(1, 2, 0).reshape(rows * s_loc, k)
    return pos, flat.reshape(k, -1, e)[0].sum(dim=0)


FAULTS = {"rank_local": ("_route", rank_local_route),
          "rank_major": ("place_blocks", lambda real: rank_major_place)}


def moe_block_cases(rank: int, world: int, spec_path: str, out_dir: str):
    """spec {config (a port MoEConfig), layer (numpy, one layer's leaves),
    x and cot (global [B, S, D] numpy), plans: [MeshPlan fields]}: for each
    plan (no fsdp: moe_block takes whole D), this rank's moe_block of its
    rows and sequence shard of x with its shard of the layer, and the
    gradients of sum(out * cot) + aux + z: x's shard, and each leaf's,
    summed as the Trainer sums them (a bank's over dp x sp, the router's
    and the norm's over every axis but tp). Saved to out_dir/rank<r>.pt
    with aux and z, this rank's shares."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.parallel.mesh import (
        MeshGroups, MeshPlan, param_sharding_rules, shard,
    )

    spec = torch.load(spec_path, weights_only=False)
    cfg = spec["config"]
    rules, kinds = param_sharding_rules(), moe.param_kinds(cfg)["layers"]
    results = {}
    for plan_d in spec["plans"]:
        plan = MeshPlan(**plan_d)
        g = MeshGroups.build(plan)
        i, n = g.rows

        def mine(x):
            rows = torch.as_tensor(x).chunk(n, dim=0)[i]
            return comm.local_shard(rows, g.sp).contiguous()
        layer = {k: shard(torch.as_tensor(v), rules[kinds[k]], plan, rank)
                 .clone().requires_grad_(True)
                 for k, v in spec["layer"].items()}
        x = mine(spec["x"]).requires_grad_(True)
        out, aux, z = moe.moe_block(x, layer, cfg, g.data, g.sp, g.ep, g.tp)
        loss = (out * mine(spec["cot"])).sum() + aux + z
        keys = list(layer)
        grads = torch.autograd.grad(loss, [x] + [layer[k] for k in keys])
        grads = dict(zip(["x"] + keys, grads))
        banks = [grads[k] for k in ("we1", "we3", "we2")]
        whole = [grads[k] for k in ("router", "mlp_norm")]
        if g.sum_group(("ep",)) is not None:
            comm.all_reduce_sum(banks, g.sum_group(("ep",)))
        if g.data is not None:
            comm.all_reduce_sum(whole, g.data)
        results[str(plan)] = {"out": out.detach(), "aux": float(aux),
                              "z": float(z), "grads": grads}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def gather_cases(rank: int, world: int, spec_path: str, out_dir: str):
    """spec [{name, tensors: [whole numpy], dims, cotangents: [[whole
    numpy] per rank]}]: each rank gathers its shards of the tensors whole
    (comm.all_gather over the world) and takes the gradient of its own
    cotangents; also gather_leaf and reduce_scatter_sum of the
    cotangents. Saved to out_dir/rank<r>.pt."""
    g = comm.AxisGroup.of()
    results = {}
    for case in torch.load(spec_path, weights_only=False):
        dims = case["dims"]
        shards = [torch.as_tensor(x).chunk(world, dim=d)[rank].clone()
                  .requires_grad_(True) for x, d in zip(case["tensors"],
                                                        dims)]
        cots = [torch.as_tensor(c) for c in case["cotangents"][rank]]
        full = comm.all_gather(shards, dims, g)
        grads = torch.autograd.grad(full, shards, cots)
        results[case["name"]] = {
            "full": [t.detach() for t in full], "grads": grads,
            "leaf": [comm.gather_leaf(t, d, g) for t, d in zip(shards,
                                                               dims)],
            "scattered": comm.reduce_scatter_sum(cots, dims, g)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def tp_cases(rank: int, world: int, spec_path: str, out_dir: str):
    """spec {x, w: [per rank], parts: [[per rank] per dtype], cots,
    logits, targets, ll_cot, embed, tokens, embed_cot} (numpy): over the
    world as a tp group, copy_to_group of x and the gradient of this
    rank's sum(y * w[rank]); reduce_from_group of this rank's parts and
    their gradients of `cots`; the vocab-parallel log-likelihood of this
    rank's vocab chunk of `logits` and its gradient of `ll_cot`; the
    vocab-parallel lookup of `tokens` in this rank's chunk of `embed` and
    its gradient of `embed_cot`. Saved to out_dir/rank<r>.pt."""
    from gpu_docker_api_tpu_torch.models.llama import vocab_embedding
    from gpu_docker_api_tpu_torch.train import _log_likelihood

    g = comm.AxisGroup.of()
    spec = torch.load(spec_path, weights_only=False)
    x = torch.as_tensor(spec["x"]).requires_grad_(True)
    y = comm.copy_to_group(x, g)
    copy_grad, = torch.autograd.grad(
        (y * torch.as_tensor(spec["w"][rank])).sum(), x)
    parts = [torch.as_tensor(p[rank]).requires_grad_(True)
             for p in spec["parts"]]
    sums = [comm.reduce_from_group(p, g) for p in parts]
    reduce_grads = torch.autograd.grad(
        sums, parts, [torch.as_tensor(c) for c in spec["cots"]])
    logits = torch.as_tensor(spec["logits"]).chunk(world, dim=-1)[rank]
    logits = logits.clone().requires_grad_(True)
    ll = _log_likelihood(logits, torch.as_tensor(spec["targets"]), g)
    ll_grad, = torch.autograd.grad(ll, logits,
                                   torch.as_tensor(spec["ll_cot"]))
    embed = torch.as_tensor(spec["embed"]).chunk(world, dim=0)[rank]
    embed = embed.clone().requires_grad_(True)
    rows = vocab_embedding(torch.as_tensor(spec["tokens"]), embed, g)
    embed_grad, = torch.autograd.grad(rows, embed,
                                      torch.as_tensor(spec["embed_cot"]))
    torch.save({"copy": y.detach(), "copy_grad": copy_grad,
                "sums": [t.detach() for t in sums],
                "reduce_grads": reduce_grads, "ll": ll.detach(),
                "ll_grad": ll_grad, "rows": rows.detach(),
                "embed_grad": embed_grad},
               os.path.join(out_dir, f"rank{rank}.pt"))


def pipeline_cases(rank: int, world: int, spec_path: str, out_dir: str):
    """spec [{name, config (a port config), params (whole canonical numpy
    tree), tokens [B, S] numpy, plan (MeshPlan fields), microbatches,
    virtual_stages, pregrouped}]: this rank's pipeline_forward of its rows
    (Trainer.shard_batch's) with its shards of the params (param_specs
    under pp; grouped when pregrouped), no gradient. Saved to
    out_dir/rank<r>.pt: the logits (None off the last stage), the router
    loss (MoE), the global rows this rank took, its coordinates."""
    from gpu_docker_api_tpu_torch import convert
    from gpu_docker_api_tpu_torch.parallel import pipeline
    from gpu_docker_api_tpu_torch.parallel.mesh import (
        MeshGroups, MeshPlan, coords, shard_params,
    )
    from gpu_docker_api_tpu_torch.train import (
        Trainer, TrainConfig, param_specs,
    )

    results = {}
    for case in torch.load(spec_path, weights_only=False):
        cfg, plan = case["config"], MeshPlan(**case["plan"])
        m, v = case["microbatches"], case["virtual_stages"]
        groups = MeshGroups.build(plan)
        trainer = Trainer.create(cfg, plan, tc=TrainConfig(
            n_microbatches=m, virtual_stages=v), device="cpu", groups=groups)
        params = convert.params_from_numpy(case["params"], cfg)
        if case["pregrouped"]:
            params["layers"] = pipeline.group_layers(params["layers"],
                                                     plan.pp, v)
        params = shard_params(params, param_specs(
            cfg, True, v if case["pregrouped"] else 1), plan, rank)
        tokens = torch.as_tensor(case["tokens"]).long()
        rows = trainer.shard_batch(torch.arange(tokens.shape[0])[:, None])
        with torch.no_grad():
            out = pipeline.pipeline_forward(
                params, trainer.shard_batch(tokens), cfg, groups,
                n_microbatches=m, virtual_stages=v,
                pregrouped=case["pregrouped"])
        logits, router = out if isinstance(out, tuple) else (out, None)
        results[case["name"]] = {
            "logits": logits, "router": None if router is None
            else float(router), "rows": rows[:, 0].tolist(),
            "coords": coords(plan, rank)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run(target, payload, world: int, tmp_dir: str, timeout: float = 120.0):
    """Test-side: save `payload`, run target(rank, world, payload path,
    tmp_dir) over `world` gloo ranks (a file rendezvous in tmp_dir; a hang
    fails within `timeout`), and return each rank's saved results."""
    from gpu_docker_api_tpu_torch import distributed
    path = os.path.join(tmp_dir, "payload.pt")
    torch.save(payload, path)
    distributed.launch(target, (path, tmp_dir), world, "gloo",
                       init_method=f"file://{os.path.join(tmp_dir, 'rdzv')}",
                       timeout=timeout)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def contract_rank(rank: int, env: dict, out_dir: str):
    """A worker of the multi-worker contract: form the group from `env`
    alone (maybe_initialize_from_env, gloo), sum the ranks, save."""
    import torch.distributed as dist

    from gpu_docker_api_tpu_torch import distributed
    torch.set_num_threads(1)
    spec = distributed.maybe_initialize_from_env(env, device="cpu")
    again = distributed.maybe_initialize_from_env(env, device="cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    torch.save({"spec": spec, "again": again, "sum": float(x),
                "backend": dist.get_backend()},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def die_on_rank_1(rank: int, world: int, path: str, out_dir: str):
    """Rank 1 fails at once; the others sleep (only the launcher can stop
    them)."""
    import time
    if rank == 1:
        raise SystemExit(3)
    time.sleep(600)
