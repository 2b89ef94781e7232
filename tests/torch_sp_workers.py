"""Rank bodies of the port's multi-rank tests (test_torch_ring.py,
test_torch_ulysses.py, test_torch_sp_train.py, test_torch_distributed.py,
test_torch_mesh.py, test_torch_fsdp_train.py, test_torch_tp.py,
test_torch_tp_train.py, test_torch_ep.py, test_torch_moe_ranks_train.py,
test_torch_pipeline.py, test_torch_pp_train.py, test_torch_multiworker.py,
test_torch_multihost_serving.py).

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


# ---- multi-worker runs: each worker a process formed from its contract -------

def cluster_env(worker: int, workers: int, coordinator: str) -> dict:
    """The control plane's contract for worker `worker` of `workers` on
    this host, the coordinator given (JAX_COORDINATOR_ADDRESS)."""
    return {"TPU_WORKER_HOSTNAMES": ",".join(["127.0.0.1"] * workers),
            "TPU_WORKER_ID": str(worker),
            "JAX_COORDINATOR_ADDRESS": coordinator}


def cluster_worker(env: dict, n_dev: int, target, args: tuple,
                   timeout: float):
    """One worker: its contract env alone decides its ranks (cluster_spec_
    from_env, cluster_layout over n_dev CPU devices) and the group forms at
    the coordinator (run_cluster, gloo)."""
    from gpu_docker_api_tpu_torch import distributed
    torch.set_num_threads(1)
    os.environ.update(env)
    spec = distributed.cluster_spec_from_env()
    cluster = distributed.cluster_layout(spec, "cpu", n_dev)
    distributed.run_cluster(target, args, cluster, "gloo", timeout)


def start_workers(target, args: tuple, workers: int, n_dev: int,
                  timeout: float = 120.0) -> list:
    """Test-side: `workers` worker processes (spawned, each running
    cluster_worker from its own contract env) of a run of n_dev ranks;
    target(rank, world, *args) on each rank. Returns the processes."""
    import multiprocessing as mp

    from gpu_docker_api_tpu_torch import distributed
    coordinator = f"127.0.0.1:{distributed.free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=cluster_worker, args=(
        cluster_env(w, workers, coordinator), n_dev, target, args, timeout))
        for w in range(workers)]
    for p in procs:
        p.start()
    return procs


def wait_workers(procs, timeout: float) -> list:
    """Each worker's exit code within `timeout` s in all; a worker still
    running then is killed and reads None."""
    import time
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def run_workers(target, payload, workers: int, n_dev: int, tmp_dir: str,
                timeout: float = 120.0) -> list:
    """Test-side: save `payload`, run target(rank, world, payload path,
    tmp_dir) on n_dev ranks over `workers` workers (start_workers), and
    return each global rank's saved results."""
    path = os.path.join(tmp_dir, "payload.pt")
    torch.save(payload, path)
    procs = start_workers(target, (path, tmp_dir), workers, n_dev, timeout)
    codes = wait_workers(procs, timeout)
    if codes != [0] * workers:
        raise RuntimeError(f"workers exited with {codes}")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n_dev)]


# ---- multi-host serving ------------------------------------------------------

def serve_cases(rank: int, world: int, spec_path: str, out_dir: str):
    """One rank of multi-host serving over the workers' group, tp =
    spec["tp"] (infer.serving_plan): the weights (spec["params"], a numpy
    tree of spec["config"]) cut to this rank (its leaf shapes saved);
    single-flight generate of spec["prompt"] greedy, its teacher-forced
    logits, and a sampled request (generator seed spec["seed"]); then each
    of spec["batch_cases"] ({name: {kw: _LockstepBatcher knobs, draft:
    bool, moe: bool, temperature}}) through a lock-step batcher: spec
    ["prompts"] staggered, or for MoE (spec["moe_config"], spec["moe_
    params"]) spec["moe_prompts"] under the schedule spec["moe_at"]; each
    rank's recorded streams, rank 0's in order, the cache's shapes and
    the generator's draws. Results to out_dir/rank<r>.pt."""
    import chip_smoke as cs
    from gpu_docker_api_tpu_torch import convert, infer
    from gpu_docker_api_tpu_torch.parallel import comm
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups
    from gpu_docker_api_tpu_torch.train import Trainer, tree_map_named
    from gpu_docker_api_tpu_torch.workloads import serve

    spec = torch.load(spec_path, weights_only=False)
    plan = infer.serving_plan(world, spec["tp"])
    groups = MeshGroups.build(plan)
    wire = comm.AxisGroup.of()

    def shards(config, tree):
        tr = Trainer.create(config, plan, device="cpu", groups=groups)
        return infer.RankParams(tr._shard_tree(
            convert.params_from_numpy(tree, config)), groups)

    cfg = spec["config"]
    params = shards(cfg, spec["params"])
    res = {"plan": plan, "leaf_shapes": tree_map_named(
        lambda _, t: tuple(t.shape), dict(params))}
    prompt = torch.as_tensor(spec["prompt"]).long()[None]
    n = spec["max_new"]
    res["greedy"] = infer.generate(params, prompt, cfg, n).tolist()
    seq = torch.cat([prompt, torch.tensor(res["greedy"])], dim=1)
    logits, _ = infer._forward_cached(
        params, seq, infer.init_cache(cfg, 1, seq.shape[1], device="cpu"),
        cfg)
    res["logits"] = logits
    gen = torch.Generator().manual_seed(spec["seed"])
    res["sampled"] = infer.generate(params, prompt, cfg, n, temperature=0.8,
                                    top_k=20, generator=gen).tolist()
    draft = (cfg, shards(cfg, spec["draft_params"]))
    moe_cfg = spec["moe_config"]
    moe_params = shards(moe_cfg, spec["moe_params"])
    for name, case in spec["batch_cases"].items():
        kw = dict(case["kw"])
        if case.get("draft"):
            kw["draft"] = draft
        moe = case.get("moe", False)
        b = serve._LockstepBatcher(
            moe_cfg if moe else cfg, moe_params if moe else params,
            world=wire, rank=rank, seed=11, **kw)
        cs.record_streams(b)
        gen0 = b._gen.get_state().clone()
        shapes = {k: tuple(b.cache[k].shape) for k in
                  ("k", "v", "ks", "vs", "lengths", "pages") if k in b.cache}
        prompts = [torch.as_tensor(p).long()
                   for p in spec["moe_prompts" if moe else "prompts"]]
        if moe:
            out = cs.lockstep_scheduled(torch, b, rank, prompts,
                                        spec["moe_at"], n)
            b.close()
        else:
            out = cs.lockstep_staggered(
                b, rank, prompts, n, spec["stagger"],
                temperature=case.get("temperature", 0.0))
        res[name] = {"out": out, "recorded": b.recorded,
                     "cache_shapes": shapes,
                     "drew": not torch.equal(gen0, b._gen.get_state())}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def serve_main_worker(env: dict, argv: list, fail_rank: int = -1,
                      fail_at: int = 3, idle_s: float = 0.0,
                      rounds_path: str = ""):
    """A worker process of `serve.main(argv)` from its contract env; with
    fail_rank set, that global rank's lock-step scheduler raises at its
    fail_at-th tick (a planted crash). idle_s > 0 sets the single-flight
    idle round's period; with rounds_path each broadcast_one_to_all of
    this worker appends a line to that file. Exits with main's code."""
    os.environ.update(env)
    torch.set_num_threads(1)
    from gpu_docker_api_tpu_torch.parallel import comm
    from gpu_docker_api_tpu_torch.workloads import serve
    if idle_s > 0:
        serve.SERVE_IDLE_S = idle_s
    if rounds_path:
        bcast = comm.broadcast_one_to_all

        def counted(tensors, g):
            out = bcast(tensors, g)
            with open(rounds_path, "a") as f:
                f.write("1\n")
            return out
        comm.broadcast_one_to_all = counted
    if fail_rank >= 0:
        real = serve._LockstepBatcher._tick

        def tick(self):
            self._ticks = getattr(self, "_ticks", 0) + 1
            if self._rank == fail_rank and self._ticks >= fail_at:
                raise RuntimeError(f"planted failure on rank {fail_rank}")
            return real(self)
        serve._LockstepBatcher._tick = tick
    raise SystemExit(serve.main(argv))


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


def origin(rank: int, world: int, out_dir: str):
    """Where this rank came from: its parent's pid and the launch's
    TDAPI_LAUNCH_MARK, saved to out_dir/rank<r>.json."""
    import json
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"ppid": os.getppid(),
                   "mark": os.environ.get("TDAPI_LAUNCH_MARK")}, f)
