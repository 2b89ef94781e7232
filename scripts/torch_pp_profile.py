#!/usr/bin/env python3
"""Where chip_smoke.py 12a's pipeline step spends its time.

Runs phase 12a's layout as phase 12 runs it: four gloo ranks forked on one
CUDA card (distributed.launch), llama 1b at full width and 4 of its 20
layers, pp=4 GPipe over 4 microbatches, B=4, S=2048, bf16, stage remat,
phase 9's batches. Each rank times on the host clock its Trainer's
creation, its init and each of --steps steps (synchronised), and traces
each step with torch.profiler (CPU and CUDA activities): the ops with the
most self CPU time, the step's summed device time and its busy share.
Writes one JSON object to --out and prints a summary line. Entering
torch.profiler imports torch._dynamo, so a traced step never pays that
import, which an untraced rank's first checkpointed step does (phase 12's
own step times show it).

--via runs the same layout through other paths, in turn, for a step that
is slow in phase 12 but not here: "layout" through chip_smoke.layout_rank
itself (its launch counters, tp-sum and head recorders installed), each
Trainer.step traced the same way; "one-rank" first runs phase 12's
one-rank references in this process (phase_pp's sp_train of llama and
MoE), then "layout" again.

    python3 scripts/torch_pp_profile.py --out pp_profile.json
    python3 scripts/torch_pp_profile.py --via own layout one-rank
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOP = 15


def summarize(prof, wall_s) -> dict:
    """The profile's top ops by self CPU time, and the device time."""
    rows = prof.key_averages()
    top = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)
    device_us = sum(getattr(r, "self_device_time_total",
                            getattr(r, "self_cuda_time_total", 0))
                    for r in rows)
    return {"top_self_cpu_ms": [
                {"op": r.key, "calls": r.count,
                 "self_cpu_ms": r.self_cpu_time_total / 1e3}
                for r in top[:TOP]],
            "device_ms": device_us / 1e3,
            "busy": device_us / 1e6 / wall_s if wall_s else None}


def rank_main(rank, world, tmp, spec):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer, TrainConfig

    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.init()
    config, plan_d, attn, _, opts = cs.layout_fields(
        cs.pp_layouts(cs.PP_CONFIGS, cs.PP_TRAIN)["12a"])
    config = spec.get("config", config)
    cfg = dataclasses.replace(cs.smoke_config(config), sp_attn=attn)
    b, s = opts["b"], cs.PP_TRAIN["s"]
    out = {"rank": rank, "plan": plan_d, "tc": opts["tc"], "b": b, "s": s}
    t0 = time.perf_counter()
    plan = MeshPlan(**plan_d)
    groups = MeshGroups.build(plan)
    trainer = Trainer.create(cfg, plan, tc=TrainConfig(**opts["tc"]),
                             device=device, groups=groups)
    out["create_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = trainer.init(seed=0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    out["init_s"] = time.perf_counter() - t0
    out["steps"] = []
    for step in range(spec["steps"]):
        tokens = trainer.shard_batch(cs.train_batch(torch, cfg, b, s, 0,
                                                    step))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = trainer.step(state, tokens)
            loss = float(m["loss"])
            sync()
            wall = time.perf_counter() - t0
        out["steps"].append({"wall_s": wall, "loss": loss,
                             **summarize(prof, wall)})
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def layout_rank_traced(rank, world, tmp, spec):
    """chip_smoke.layout_rank over spec["layouts"], each Trainer.step
    timed and traced as rank_main times and traces its steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gpu_docker_api_tpu_torch import train

    steps = []
    inner = train.Trainer.step

    def step(self, state, tokens):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = inner(self, state, tokens)
            float(out[1]["loss"])
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps.append({"wall_s": wall, **summarize(prof, wall)})
        return out
    train.Trainer.step = step
    cs.layout_rank(rank, world, tmp, spec)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "create_s": None, "init_s": None,
                   "steps": steps}, f)


def run_ranks(cs, distributed, target, spec) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        distributed.launch(target, (tmp, spec), cs.PP_RANKS, "gloo",
                           timeout=cs.LAYOUTS_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        return ranks_s, [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                         for r in range(cs.PP_RANKS)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", default="pp_profile.json")
    p.add_argument("--via", nargs="+", default=["own"],
                   choices=["own", "layout", "one-rank"])
    args = p.parse_args(argv)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: 12a runs on the card")
    import chip_smoke as cs
    from gpu_docker_api_tpu_torch import distributed
    layouts = cs.pp_layouts(cs.PP_CONFIGS, cs.PP_TRAIN)
    layout_spec = {"device": "cuda:0", "layouts": {"12a": layouts["12a"]},
                   "train": cs.PP_TRAIN, "checkpoint": ""}
    runs = {}
    cs.start_rank_server()
    try:
        smi, _ = cs.build_kernels(torch)
        cs.await_rank_server()
        for via in args.via:
            if via == "own":
                runs[via] = run_ranks(cs, distributed, rank_main,
                                      {"steps": args.steps,
                                       "device": "cuda:0"})
                continue
            if via == "one-rank":
                llama, moe = cs.PP_CONFIGS["llama"], cs.PP_CONFIGS["moe"]
                cs.sp_train(torch, "cuda", cs.smoke_config(llama),
                            cs.PP_TRAIN, "ring")
                torch.cuda.empty_cache()
                m = cs.PP_LAYOUTS["12d"][3]["n_microbatches"]
                cs.sp_train(torch, "cuda", cs.smoke_config(moe),
                            dict(cs.PP_TRAIN, b=layouts["12d"][4]["b"]),
                            "ring", microbatches=m)
                torch.cuda.empty_cache()
            runs[via] = run_ranks(cs, distributed, layout_rank_traced,
                                  layout_spec)
    finally:
        cs.stop_rank_server()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"card": card.strip(),
              "runs": {via: {"launch_to_exit_s": ranks_s, "ranks": ranks}
                       for via, (ranks_s, ranks) in runs.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"card": result["card"], "runs": {
        via: {"launch_to_exit_s": ranks_s,
              "step_wall_s": [[st["wall_s"] for st in r["steps"]]
                              for r in ranks],
              "busy": [[st["busy"] for st in r["steps"]] for r in ranks]}
        for via, (ranks_s, ranks) in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
