#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its device time.

Runs the port's Trainer on one CUDA card (llama 1b, B=4, S=2048: the
main path of chip_smoke.py; or with --family moe, moe_1b at B=8, S=2048:
phase 7a's cell), warms up, then times a few steps and traces a few more
with torch.profiler, summing the device time by kernel family: the three
flash kernels, the matrix products (library GEMMs), sorts, index kernels
(gathers, scatters, index_select and its backward) and everything else. Reports step time (host clock around synchronised
steps), tokens/s, device-busy share of the traced window, peak device
memory, and the model FLOP rate against the card's dense bf16 peak.
Writes the whole result as JSON to --out.

    python3 scripts/torch_step_profile.py --out chiprun_out/step_profile.json
    python3 scripts/torch_step_profile.py --family moe --out moe_profile.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
CONFIG, SEQ = "1b", 2048
BATCH = {"llama": 4, "moe": 8}
WARMUP, STEPS = 2, 3
# a device function whose name holds one of these belongs to that kernel's
# family: flash_fwd_kernel_wgmma (bf16) and flash_fwd_kernel (f32) to the
# forward, flash_bwd_dq_kernel_wgmma and flash_bwd_dq_kernel to dQ,
# flash_bwd_dkv_kernel_delta (the delta pre-pass) and
# flash_bwd_dkv_kernel_wgmma to dK/dV. Matched before GEMM_MARKS.
FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")
SORT_MARKS = ("sort", "radix")
INDEX_MARKS = ("index", "scatter", "gather")


def family(name: str) -> str:
    for k in FLASH:
        if k in name:
            return k
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    if any(m in low for m in SORT_MARKS):
        return "sort"
    if any(m in low for m in INDEX_MARKS):
        return "index"
    return "other"


def model_flops(cfg, b: int, s: int, recompute_fwd_attention: bool) -> float:
    """Matmul FLOPs of one train step: 6 * (non-embedding matmul params) *
    tokens for the projections, MLP and lm_head, plus causal attention
    (QK^T and PV: 4*D per visible pair forward, twice that backward, and
    the forward again when remat reruns it)."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.head_dim
    per_layer = d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv_heads * hd) * 2 \
        + 3 * d * cfg.d_ff
    dense = 6 * (L * per_layer + d * cfg.vocab_size) * b * s
    pairs = b * cfg.n_heads * s * (s + 1) // 2
    attn_fwd = 4 * hd * pairs
    attn = L * (attn_fwd * (3 + (1 if recompute_fwd_attention else 0)))
    return dense + attn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default="llama", choices=["llama", "moe"])
    p.add_argument("--remat-policy", default="dots",
                   choices=["none", "full", "dots"])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpu_docker_api_tpu_torch.data import SyntheticDataset
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.ops import attention as att
    from gpu_docker_api_tpu_torch.train import Trainer, TrainConfig

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: device times cannot be measured here")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cfg = named_config(args.family, CONFIG)
    batch = BATCH[args.family]
    tc = TrainConfig(remat=args.remat_policy != "none",
                     remat_policy=args.remat_policy)
    trainer = Trainer.create(cfg, tc=tc)
    state = trainer.init(seed=0)
    data = SyntheticDataset(cfg.vocab_size, batch, SEQ, seed=1)

    def run(step):
        tokens = trainer.shard_batch(data.batch_at(step))
        _, m = trainer.step(state, tokens)
        return float(m["loss"])

    for i in range(WARMUP):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        run(WARMUP + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)

    att.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            run(100 + i)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    launches = dict(att.LAUNCHES)

    by_family: dict[str, float] = {}
    by_kernel: dict[str, float] = {}
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        fam = family(evt.name)
        by_family[fam] = by_family.get(fam, 0.0) + (end - start) / 1e3
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + (end - start) / 1e3
        intervals.append((start, end))
    if not intervals:
        raise SystemExit("the profiler recorded no device time")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window_us = intervals[-1][1] - intervals[0][0]
    total_ms = sum(by_family.values())
    step_med = float(np.median(step_s))
    if args.family == "moe":
        # the JAX bench's active-expert count, as chip_smoke.py phase 7a
        from chip_smoke import moe_train_flops
        flops = moe_train_flops(cfg, batch, SEQ)
    else:
        flops = model_flops(cfg, batch, SEQ, recompute_fwd_attention=(
            args.remat_policy != "none"))
    result = {
        "card": smi,
        "family": args.family, "config": CONFIG, "batch": batch, "seq": SEQ,
        "remat_policy": args.remat_policy,
        "step_s": step_s, "step_s_median": step_med,
        "tokens_s": batch * SEQ / step_med,
        "model_tflops_per_step": flops / 1e12,
        "model_flops_share_of_bf16_peak": flops / step_med / PEAK_BF16_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "traced_steps": STEPS, "traced_wall_s": traced_s,
        "device_busy_share_of_window": busy / window_us,
        "device_ms_per_step_by_family": {
            k: v / STEPS for k, v in sorted(by_family.items())},
        "device_share_by_family": {
            k: v / total_ms for k, v in sorted(by_family.items())},
        "launches_in_trace": launches,
        "top_kernels_ms_per_step": dict(sorted(
            ((k, v / STEPS) for k, v in by_kernel.items()),
            key=lambda kv: -kv[1])[:15]),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
