#!/usr/bin/env python3
"""One 8-slot decode step of the PyTorch port's serving path at llama 1b
(bf16) on one CUDA card: the dense slot cache (batching.slot_decode) against
the paged pool (paging.paged_decode, 16-token blocks), at the same contexts.

Both caches get the same eight 256-token prompts, then run the same greedy
decode steps in turns (dense, paged, paged, dense: the host is shared and
drifts, so only turns in one process compare). Each turn times STEPS steps
on the host clock around a synchronise; then one traced window a cache
counts its kernel launches and top-level operators a step, sums the
kernels' device time a step, and names the kernels that take the most of
it. Then the same comparison one level up, through the batcher: the
decode window of chip_smoke.batcher_busy (8 full slots, the scheduler
thread's own ticks) on a dense and a paged _Batcher, again in turns.
Writes the readings, with the card's name and power limit, as JSON to
--out.

    python3 scripts/torch_paged_decode.py --out chiprun_out/paged_decode.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SLOTS, PROMPT, MAX_LEN, BLOCK = 8, 256, 1024, 16
STEPS, TRACED = 32, 8


def prefilled(torch, cfg, params):
    """{"dense": (decode fn, cache), "paged": (decode fn, cache)} with the
    same prompts prefilled into every slot, and the first tokens."""
    from gpu_docker_api_tpu_torch import batching, paging
    gen = torch.Generator(device="cuda").manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT),
                            generator=gen, device="cuda")
    dense = batching.init_slot_cache(cfg, SLOTS, MAX_LEN)
    pages = MAX_LEN // BLOCK
    paged = paging.init_paged_cache(cfg, 1 + SLOTS * pages, BLOCK, SLOTS,
                                    pages)
    first = []
    for i in range(SLOTS):
        paging.set_pages(paged, i, range(1 + i * pages, 1 + (i + 1) * pages))
        logits, _ = batching.slot_prefill(params, prompts[i:i + 1], dense, i,
                                          cfg)
        paging.paged_prefill(params, prompts[i:i + 1], paged, i, cfg)
        first.append(logits.argmax(dim=-1))
    toks = torch.cat(first)
    return {"dense": [batching.slot_decode, dense, toks],
            "paged": [paging.paged_decode, paged, toks.clone()]}


def run(torch, state, params, cfg, n):
    fn, cache, toks = state
    for _ in range(n):
        logits, cache = fn(params, toks, cache, [True] * SLOTS, cfg)
        toks = logits.argmax(dim=-1)
    state[2] = toks


def timed(torch, state, params, cfg):
    """Host ms a step over STEPS steps ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(torch, state, params, cfg, STEPS)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / STEPS


def traced(torch, state, params, cfg):
    """Kernel launches and device ms a step, and the top kernels by device
    time, over TRACED steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(torch, state, params, cfg, TRACED)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda
               and e.time_range.end > e.time_range.start]
    # the operators the Python code called (not those they call in turn)
    host_ops = sum(e.device_type != cuda and e.cpu_parent is None
                   and e.name.startswith("aten::") for e in events)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:80]] += (e.time_range.end - e.time_range.start) / 1e3
    device_ms = sum(by_name.values()) / TRACED
    return {"launches": len(kernels) / TRACED, "host_ops": host_ops / TRACED,
            "device_ms": device_ms,
            "top_ms": [[name, ms / TRACED]
                       for name, ms in by_name.most_common(8)]}


def main() -> int:
    import torch
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from gpu_docker_api_tpu_torch.models import llama
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads.serve import _load_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = llama.LlamaConfig.llama_1b()
    params = _load_params(Trainer.create(cfg), "")
    with torch.no_grad():
        states = prefilled(torch, cfg, params)
        for name in states:                      # warm up
            run(torch, states[name], params, cfg, 2)
        turns = []
        for name in ("dense", "paged", "paged", "dense"):
            turns.append((name, timed(torch, states[name], params, cfg)))
        trace = {name: traced(torch, states[name], params, cfg)
                 for name in ("dense", "paged")}
        context_end = states["dense"][1]["host_lengths"][0]
        del states
        torch.cuda.empty_cache()
    import chip_smoke
    windows = []
    for name in ("dense", "paged", "paged", "dense"):
        kw = {"kv_block": BLOCK} if name == "paged" else {}
        r = chip_smoke.batcher_busy(torch, cfg, params, 1, **kw)
        windows.append((name, r["step_ms"], r["busy"]))
    out = {"card": smi, "slots": SLOTS, "prompt": PROMPT, "block": BLOCK,
           "steps_a_turn": STEPS, "turns_host_ms": turns,
           "context_end": context_end, "trace": trace,
           "batcher_windows_step_ms_busy": windows}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
