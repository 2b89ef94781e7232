#!/usr/bin/env python3
"""Time the MoE paths that route on one card, from a chosen package tree.

A moe_1b training step (chip_smoke.py 7a's cell: one-rank Trainer, bf16,
B=8, S=2048, remat "dots"; host clock around synchronised steps, median
of STEPS after WARMUP) and bf16 prefill and decode at B=1 and B=8
(7c's: chip_smoke.serve_times at MOE_TIME). --root picks the checkout
whose package and chip_smoke.py run (default: this one), so two trees
compare on one card in one call: parent, change, change, parent. Prints
one JSON line.

    python3 scripts/torch_moe_times.py [--root DIR] [--label NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, STEPS = 2, 5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the times are read on the card")
    import chip_smoke as cs
    from gpu_docker_api_tpu_torch.models import moe
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    smi, _ = cs.build_kernels(torch)
    cfg = moe.MoEConfig.moe_1b()
    b, s = cs.MOE_TRAIN["b"], cs.MOE_TRAIN["s"]
    trainer = Trainer.create(cfg)
    state = trainer.init(seed=0)
    times = []
    for step in range(WARMUP + STEPS):
        tokens = trainer.shard_batch(cs.train_batch(torch, cfg, b, s, 0, step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, tokens)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del state, trainer
    torch.cuda.empty_cache()
    params = _load_params(Trainer.create(cfg), "")
    serve = {f"bf16_b{n}": cs.serve_times(torch, cfg, params,
                                          f"moe bf16 B={n}", n, **cs.MOE_TIME)
             for n in (1, 8)}
    print(json.dumps({
        "label": args.label, "root": args.root, "card": smi,
        "train_step_s": statistics.median(times[WARMUP:]),
        "train_step_times_s": times,
        "decode_ms": {k: v["decode_ms"] for k, v in serve.items()},
        "prefill_ms": {k: v["prefill_ms"] for k, v in serve.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
