#!/usr/bin/env python3
"""Read chip_smoke.py's bf16 trunk check over several seeds on one card.

For each seed, chip_smoke.trunk_readings builds the llama 1b trunk's
weights and tokens from it and runs the trunk (B=1, S=256) in f32 and bf16
through the kernels and the reference attention, and in bf16 once more for
each of chip_smoke.planted_faults standing in for its kernel. Prints one
JSON line per seed: each bf16 run's error against the f32 reference run
over the reference attention's (chip_smoke.trunk_excess), and the kernels'
ratio for each reading; then one line with, per run, the largest and the
smallest ratio over the seeds. TRUNK_MARGIN in chip_smoke.py is set from
these lines (PERF.md). --repo reads another checkout's port, as in
scripts/torch_kernel_times.py:

    python3 scripts/torch_trunk_margin.py [--repo OTHER_CHECKOUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SEEDS = (7, 1, 2, 3, 4, 5)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repo", default=REPO,
                   help="checkout whose gpu_docker_api_tpu_torch is read")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the trunk is read on the card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.ops import attention as att

    cfg = llama.LlamaConfig.llama_1b()
    n_models = len(chip_smoke.trunk_fault_models(torch, att))
    per_run = {}
    for seed in SEEDS:
        f32, bf16 = chip_smoke.trunk_readings(torch, att, cfg, seed=seed,
                                              faults=range(n_models))
        excess = chip_smoke.trunk_excess(bf16)
        ref = bf16["reference"]
        print(json.dumps({
            "seed": seed, "f32": f32, "excess": excess,
            "kernels_by_reading": {key: bf16["kernels"][key] / ref[key]
                                   for key in ref},
            "kernels": bf16["kernels"], "reference": ref}), flush=True)
        for run, x in excess.items():
            per_run.setdefault(run, []).append(x)
    print(json.dumps({
        "repo": os.path.abspath(args.repo), "card": chip_smoke.nvidia_smi(),
        "seeds": SEEDS,
        "largest": {run: max(xs) for run, xs in per_run.items()},
        "smallest": {run: min(xs) for run, xs in per_run.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
