#!/usr/bin/env python3
"""Read chip_smoke.py phase 11's checks over several seeds on one card.

For each seed: the one-rank bf16 Trainer at chip_smoke.EP_CONFIG (moe_1b's
width at the layers phase 11 runs; chip_smoke.EP_TRAIN: B=8, S=2048, 2
steps, remat "dots"; init and batches from the seed) and
each layout of chip_smoke.EP_LAYOUTS over EP_RANKS gloo ranks on the card,
the relative differences of their losses and grad norms (what EP_LOSS_TOL
and EP_NORM_TOL bound). Then, at seed 0:

- the f32 routing check (chip_smoke.f32_routes at EP_ROUTE_CAPACITY,
  assembled by routing_ranks) of the right route beside a planted
  rank-local capacity and prefix under 11a and a planted rank-major prefix
  under 11d: the right routes must pass, the planted ones fail;
- the planted rank-local route's bf16 trainer under 11a against one rank,
  and the choices the one-rank bf16 forward of the first batch drops at
  moe_1b's own capacity factor;
- the one-rank bf16 routing of the first batch run in pieces of 2 rows (a
  rank's rows in 11a and 11b) at the whole batch's capacity against the
  whole batch: the first layer where a piece routes otherwise, its flips
  and their router-probability gaps (why f32_routes routes in f32).

Prints one JSON line per seed, one for the planted faults and the
witness, then one with the largest reading of each over the seeds; the
limits in chip_smoke.py are set from these lines (PERF.md).

    python3 scripts/torch_moe_margin.py [--seeds 0 1 2 3] [--witness-only]
    python3 scripts/torch_moe_margin.py --device cpu --config tiny --b 8 --s 32 --layers 0
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

FAULTS = {"11a": "rank_local", "11d": "rank_major"}
PIECE_ROWS = 2


@contextlib.contextmanager
def planted(moe, fault):
    """models/moe with a routing fault: "rank_local" routes each rank's
    tokens by its own capacity and prefix (the exchange still runs, so the
    ranks stay in step); "rank_major" places the blocks in rank order
    within each k (all of rank 0's tokens, then rank 1's)."""
    if fault == "rank_local":
        name, real = "_route", moe._route

        def fake(ht, router, config, data=None, rows=1, n_sp=1):
            out = list(real(ht, router, config, data, rows, n_sp))
            out[5:8] = real(ht, router, config, None, rows)[5:8]
            return tuple(out)
    else:
        name, real = "place_blocks", moe.place_blocks

        def fake(oh, within, every, rank, n_sp):
            import torch
            k, rows, e, _ = oh.shape
            flat = every.permute(1, 0, 2, 3).reshape(-1, e).long()
            before = (torch.cumsum(flat, dim=0) - flat).reshape(
                k, every.shape[0], rows, e)
            pos = (within + before[:, rank][..., None]) * oh
            pos = pos.sum(dim=2).permute(1, 2, 0).reshape(-1, k)
            return pos, flat.reshape(k, -1, e)[0].sum(dim=0)
    setattr(moe, name, fake)
    try:
        yield
    finally:
        setattr(moe, name, real)


def margin_rank(rank, world, tmp, spec):
    """A rank: each seed's layouts, then seed 0's routes and the planted
    rank-local trainer."""
    import torch

    from gpu_docker_api_tpu_torch.device import resolve_device
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.parallel.mesh import (
        MeshGroups, MeshPlan, coords,
    )

    device = resolve_device(spec["device"])
    cfg, train = cs.smoke_config(spec["config"]), spec["train"]
    res = {"coords": {}}

    def groups_of(name):
        plan, attn = cs.EP_LAYOUTS[name]
        res["coords"][name] = coords(MeshPlan(**plan), rank)
        return (MeshGroups.build(MeshPlan(**plan)),
                dataclasses.replace(cfg, sp_attn=attn))

    def tidy():
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for seed in spec["seeds"]:
        for name in cs.EP_LAYOUTS:
            groups, c = groups_of(name)
            res[seed, name] = cs.sp_train(torch, device, c, train,
                                          c.sp_attn, groups, seed=seed)
            tidy()
    tokens = cs.train_batch(torch, cfg, train["b"], train["s"], 0, 0)
    for name, fault in FAULTS.items():
        groups, c = groups_of(name)
        res[name, "right"] = cs.f32_routes(torch, c, groups, device, tokens)
        tidy()
        with planted(moe, fault):
            res[name, fault] = cs.f32_routes(torch, c, groups, device,
                                             tokens)
        tidy()
    groups, c = groups_of("11a")
    with planted(moe, "rank_local"):
        res["11a", "rank_local_train"] = cs.sp_train(
            torch, device, c, train, c.sp_attn, groups, seed=0)
    tidy()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def bf16_routes(torch, cfg, device, tokens):
    """Each layer's routing (RoutingRecorder) in a forward of the loss on
    `tokens` at cfg's dtype, one rank, init 0."""
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import Trainer

    trainer = Trainer.create(cfg, device=device)
    params = trainer.init(seed=0)["params"]
    with torch.no_grad(), cs.RoutingRecorder(moe) as rec:
        trainer._loss(params, trainer.shard_batch(tokens))
    return [tuple(t.cpu() for t in call) for call in rec.calls]


def witness(torch, cfg, device, tokens):
    """The whole batch's bf16 routing against its pieces of PIECE_ROWS
    rows run alone, at the whole batch's capacity (the capacity factor
    times B / PIECE_ROWS: where the whole batch drops nothing, neither
    does a piece): for each piece the first layer where a decision
    differs, the flips there and the reference's gaps at them; and the
    whole batch's drops a layer."""
    whole = bf16_routes(torch, cfg, device, tokens)
    s = tokens.shape[1]
    piece_cfg = dataclasses.replace(cfg, capacity_factor=cfg.capacity_factor
                                    * tokens.shape[0] / PIECE_ROWS)
    pieces = []
    for lo in range(0, tokens.shape[0], PIECE_ROWS):
        got = bf16_routes(torch, piece_cfg, device,
                          tokens[lo:lo + PIECE_ROWS])
        seen = {"rows": [lo, lo + PIECE_ROWS], "layer": None}
        for layer, ((ri, _, rtop), (gi, _, _)) in enumerate(zip(whole, got)):
            ri, rtop = ri[lo * s:(lo + PIECE_ROWS) * s], rtop[
                lo * s:(lo + PIECE_ROWS) * s]
            flipped = (ri != gi).any(dim=-1)
            if bool(flipped.any()):
                gaps = (rtop[:, :-1] - rtop[:, 1:]).min(dim=-1).values
                seen = {**seen, "layer": layer,
                        "flips": int(flipped.sum()),
                        "gaps": sorted(float(g) for g in gaps[flipped])}
                break
        pieces.append(seen)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"drops_a_layer": cs.route_drops(whole), "pieces": pieces}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=cs.EP_CONFIG[1])
    p.add_argument("--layers", type=int, default=cs.EP_CONFIG[2] or 0,
                   help="the depth cut (0: the config's own depth)")
    p.add_argument("--b", type=int, default=cs.EP_TRAIN["b"])
    p.add_argument("--s", type=int, default=cs.EP_TRAIN["s"])
    p.add_argument("--witness-only", action="store_true",
                   help="print the bf16 witness alone")
    args = p.parse_args(argv)

    import torch
    from gpu_docker_api_tpu_torch import distributed
    from gpu_docker_api_tpu_torch.device import resolve_device

    smi = "not read (cpu)"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: the margins are read on the card")
        smi, _ = cs.build_kernels(torch)
    device = resolve_device(args.device)
    config = ("moe", args.config, args.layers or None)
    cfg = cs.smoke_config(config)
    tokens = cs.train_batch(torch, cfg, args.b, args.s, 0, 0)
    if args.witness_only:
        print(json.dumps({"bf16_witness": witness(torch, cfg, device, tokens),
                          "card": smi}), flush=True)
        return 0
    train = dict(cs.EP_TRAIN, b=args.b, s=args.s)
    one = {}
    for seed in args.seeds:
        one[seed] = cs.sp_train(torch, device, cfg, train, "ring", seed=seed)
    ref = cs.f32_routes(torch, cfg, None, device, tokens)
    seen = witness(torch, cfg, device, tokens)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    spec = {"device": f"{args.device}:0" if args.device == "cuda"
            else args.device, "config": config, "train": train,
            "seeds": args.seeds}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.launch(margin_rank, (tmp, spec), cs.EP_RANKS, "gloo",
                           timeout=3000)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(cs.EP_RANKS)]

    def rel(got, base):
        return {"loss": [abs(a / b - 1) for a, b in zip(got["losses"],
                                                        base["losses"])],
                "grad_norm": [abs(a / b - 1) for a, b in zip(
                    got["grad_norms"], base["grad_norms"])]}

    worst: dict = {}
    for seed in args.seeds:
        line = {"seed": seed, "one_rank": one[seed], "layouts": {}}
        for name in cs.EP_LAYOUTS:
            got = ranks[0][seed, name]
            same = all(r[seed, name]["losses"] == got["losses"] and
                       r[seed, name]["grad_norms"] == got["grad_norms"]
                       for r in ranks)
            r = rel(got, one[seed])
            line["layouts"][name] = {"rel": r, "ranks_alike": same,
                                     "losses": got["losses"],
                                     "grad_norms": got["grad_norms"]}
            for key, vals in r.items():
                worst[f"{name} {key}"] = max(worst.get(f"{name} {key}", 0.0),
                                             max(vals))
        print(json.dumps(line), flush=True)
    planted_line = {"f32_route_drops_a_layer": cs.route_drops(ref),
                    "route_capacity": cs.EP_ROUTE_CAPACITY, "routes": {}}
    for name, fault in FAULTS.items():
        plan = cs.EP_LAYOUTS[name][0]
        for variant in ("right", fault):
            runs = [{"coords": r["coords"][name], "routes": r[name, variant]}
                    for r in ranks]
            try:
                out = {"flips": cs.routing_ranks(ref, runs, plan, name,
                                                 args.b, args.s)}
            except cs.SmokeFailure as e:
                out = {"failed": str(e)[:300]}
            planted_line["routes"][f"{name} {variant}"] = out
    planted_line["11a rank_local bf16 trainer"] = rel(
        ranks[0]["11a", "rank_local_train"], one[args.seeds[0]]) if (
        args.seeds[0] == 0) else None
    planted_line["bf16_witness"] = seen
    print(json.dumps(planted_line), flush=True)
    print(json.dumps({"worst_over_seeds": worst, "seeds": args.seeds,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
