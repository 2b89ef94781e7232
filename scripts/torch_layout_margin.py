#!/usr/bin/env python3
"""Read the layout checks of chip_smoke.py phases 9, 10 and 12 over several
seeds on one card.

For each phase asked for and each seed: the one-rank bf16 Trainer of each
config the phase's layouts run (llama 1b's width at the phase's depth
cut, and for 12d moe_1b's at its cut, whose reference is the plain
microbatched version at 12d's batch, as phase 12 runs it; the phase's
batch shape, 2 steps, remat "dots"; init and batches from the seed) and
each layout of the phase (FSDP_LAYOUTS, TP_LAYOUTS, PP_LAYOUTS) over 4
gloo ranks on the card, the relative differences of their losses and
grad norms (what SP_LOSS_TOL and SP_NORM_TOL bound for llama, EP_LOSS_TOL
and EP_NORM_TOL for MoE). Prints one JSON line per phase and seed, then
one with the largest reading of each layout over the seeds (PERF.md).

    python3 scripts/torch_layout_margin.py [--phases 9 10 12] [--seeds 0 1 2 3]
    python3 scripts/torch_layout_margin.py --device cpu --config tiny --s 32
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


RANKS = 4


def layouts_of(phase: int, train: dict, config: str = "") -> dict:
    """The layouts of `phase` as run_layouts takes them, each config at its
    depth cut (`config`: another config name of each family at the same
    cuts)."""
    def named(spec):
        return (spec[0], config, spec[2]) if config and isinstance(
            spec, tuple) else spec
    if phase == 9:
        return {name: (named(cs.FSDP_CONFIG), plan, "ring", steps)
                for name, (plan, steps) in cs.FSDP_LAYOUTS.items()}
    if phase == 10:
        return {name: (named(cs.TP_CONFIGS[role]), plan, attn,
                       train["steps"])
                for name, (role, plan, attn) in cs.TP_LAYOUTS.items()}
    layouts = cs.pp_layouts({k: named(v) for k, v in cs.PP_CONFIGS.items()},
                            train)
    return layouts


def is_moe(config) -> bool:
    return isinstance(config, tuple) and config[0] == "moe"


def margin_rank(rank, world, tmp, spec):
    """A rank: each phase's llama layouts at each seed."""
    import torch

    from gpu_docker_api_tpu_torch.device import resolve_device
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan

    device = resolve_device(spec["device"])
    res = {}
    for phase, (layouts, train) in spec["phases"].items():
        for seed in spec["seeds"]:
            for name, entry in layouts.items():
                config, plan, attn, _, opts = cs.layout_fields(entry)
                groups = MeshGroups.build(MeshPlan(**plan))
                res[seed, name] = cs.sp_train(
                    torch, device, cs.smoke_config(config),
                    dict(train, b=opts.get("b", train["b"])), attn,
                    groups, seed=seed, tc=opts.get("tc"))
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", type=int, nargs="+", default=[9, 10, 12],
                   choices=(9, 10, 12))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="",
                   help="another config name (llama's and MoE's) for "
                        "every cut layout, at the same depth cuts")
    p.add_argument("--s", type=int, default=2048)
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
    trains = {9: cs.FSDP_TRAIN, 10: cs.TP_TRAIN, 12: cs.PP_TRAIN}
    phases = {}
    for phase in args.phases:
        train = dict(trains[phase], s=args.s)
        phases[phase] = (layouts_of(phase, train, args.config), train)
    one = {}
    for phase, (layouts, train) in phases.items():
        for seed in args.seeds:
            for entry in layouts.values():
                config, _, _, _, opts = cs.layout_fields(entry)
                b = opts.get("b", train["b"])
                if (seed, config, b) in one:
                    continue
                m = opts["tc"]["n_microbatches"] if is_moe(config) else 0
                one[seed, config, b] = cs.sp_train(
                    torch, device, cs.smoke_config(config), dict(train, b=b),
                    "ring", seed=seed, microbatches=m)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    spec = {"device": f"{args.device}:0" if args.device == "cuda"
            else args.device, "phases": phases, "seeds": args.seeds}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.launch(margin_rank, (tmp, spec), RANKS, "gloo",
                           timeout=3000)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(RANKS)]
    worst: dict = {}
    for (phase, (layouts, train)), seed in itertools.product(
            phases.items(), args.seeds):
        line = {"phase": phase, "seed": seed, "layouts": {}}
        for name, entry in layouts.items():
            got = ranks[0][seed, name]
            opts = cs.layout_fields(entry)[4]
            base = one[seed, entry[0], opts.get("b", train["b"])]
            same = all(r[seed, name]["losses"] == got["losses"] and
                       r[seed, name]["grad_norms"] == got["grad_norms"]
                       for r in ranks)
            rel = {"loss": [abs(a / b - 1) for a, b in zip(
                       got["losses"], base["losses"])],
                   "grad_norm": [abs(a / b - 1) for a, b in zip(
                       got["grad_norms"], base["grad_norms"])]}
            line["layouts"][name] = {"config": entry[0], "rel": rel,
                                     "ranks_alike": same,
                                     "losses": got["losses"],
                                     "grad_norms": got["grad_norms"]}
            for key, vals in rel.items():
                worst[f"{name} {key}"] = max(worst.get(f"{name} {key}", 0.0),
                                             max(vals))
        print(json.dumps(line), flush=True)
    print(json.dumps({"worst_over_seeds": worst, "seeds": args.seeds,
                      "limits": {"loss": cs.SP_LOSS_TOL,
                                 "grad_norm": cs.SP_NORM_TOL},
                      "moe_limits": {"loss": cs.EP_LOSS_TOL,
                                     "grad_norm": cs.EP_NORM_TOL},
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
