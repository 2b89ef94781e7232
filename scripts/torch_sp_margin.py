#!/usr/bin/env python3
"""Read chip_smoke.py phase 8's bf16 sequence-parallel checks over several
seeds on one card.

For each seed: 8b's bf16 cases (chip_smoke.SP_CASES: the causal flash
ring, the windowed ring, the einsum ring and Ulysses over SP_RANKS gloo
ranks on the card, S=SP_S) on inputs made from the seed, each rank's
Frobenius error over the bf16 whole-S kernel's against the f32 whole-S
kernel (what long_check holds to TRUNK_MARGIN); and 8c's bf16 Trainer at
llama 1b (SP_TRAIN, ring and Ulysses, init and batches from the seed)
against the one-rank Trainer, the relative differences of its losses and
grad norms (what SP_LOSS_TOL and SP_NORM_TOL bound). Prints one JSON line
per seed, then one with the largest reading of each over the seeds; the
limits in chip_smoke.py are set from these lines (PERF.md).

    python3 scripts/torch_sp_margin.py [--seeds 0 1 2 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def margin_rank(rank, world, tmp, seeds):
    """A rank: for each seed, 8b's bf16 cases and 8c's bf16 runs."""
    import torch

    from gpu_docker_api_tpu_torch.device import resolve_device
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan

    device = resolve_device("cuda:0")
    cfg = cs.smoke_config(cs.SP_CONFIG)
    groups = MeshGroups.build(MeshPlan(sp=world))
    res = {}
    for seed in seeds:
        inputs = torch.load(os.path.join(tmp, f"inputs{seed}.pt"))
        res[seed] = {"cases": cs.sp_cases(torch, groups.sp, device, inputs,
                                          (torch.bfloat16,))}
        del inputs
        for attn in ("ring", "ulysses"):
            res[seed][attn] = cs.sp_train(torch, device, cfg, cs.SP_TRAIN,
                                          attn, groups, seed=seed)
            torch.cuda.empty_cache()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the margins are read on the card")
    from gpu_docker_api_tpu_torch import distributed

    smi, att = cs.build_kernels(torch)
    cfg = cs.smoke_config(cs.SP_CONFIG)
    refs, one = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            q, k, v, do = cs.long_inputs(torch, cs.SP_S, 88 + seed)
            refs[seed] = cs.sp_refs(torch, att, q, k, v, do)
            torch.save([x.cpu() for x in (q, k, v, do)],
                       os.path.join(tmp, f"inputs{seed}.pt"))
            del q, k, v, do
            one[seed] = cs.sp_train(torch, "cuda", cfg, cs.SP_TRAIN, "ring",
                                    seed=seed)
            torch.cuda.empty_cache()
        distributed.launch(margin_rank, (tmp, args.seeds), cs.SP_RANKS,
                           "gloo", timeout=3000)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(cs.SP_RANKS)]
    worst: dict = {}
    for seed in args.seeds:
        line = {"seed": seed, "excess": {}, "train": {}}
        for (name, _), _ in ranks[0][seed]["cases"].items():
            ref = refs[seed][cs.SP_CASES[name][2]]
            per_rank = []
            for r, res in enumerate(ranks):
                got = res[seed]["cases"][(name, str(torch.bfloat16))]
                shard = [[t.chunk(cs.SP_RANKS, dim=1)[r] for t in ts]
                         for ts in (ref["f32"], ref["bf16"])]
                per_rank.append({
                    n: cs.long_readings(torch, g, f)[0]
                    / cs.long_readings(torch, k, f)[0]
                    for n, g, f, k in zip(cs.GRAD_NAMES, got["shards"],
                                          *shard)})
            line["excess"][name] = per_rank
            worst[f"excess {name}"] = max(
                worst.get(f"excess {name}", 0.0),
                max(max(x.values()) for x in per_rank))
        for attn in ("ring", "ulysses"):
            got = ranks[0][seed][attn]
            rel = {"loss": [abs(a / b - 1) for a, b in zip(
                       got["losses"], one[seed]["losses"])],
                   "grad_norm": [abs(a / b - 1) for a, b in zip(
                       got["grad_norms"], one[seed]["grad_norms"])]}
            line["train"][attn] = {"rel": rel, "losses": got["losses"],
                                   "one_rank_losses": one[seed]["losses"]}
            for key, vals in rel.items():
                worst[f"{attn} {key}"] = max(worst.get(f"{attn} {key}", 0.0),
                                             max(vals))
        print(json.dumps(line), flush=True)
    print(json.dumps({"worst_over_seeds": worst, "seeds": args.seeds,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
