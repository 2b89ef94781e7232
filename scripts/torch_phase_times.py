#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py from a chosen checkout, and time them.

The phases, in their order in the script: 4 (serving), 5 (the dense
batcher), 6 (the paged cache; with 5, whose readings it prints beside its
own), 7 (MoE), 12 (pp), 13 (multi-worker grants), 14 (the node layer), 16
(the port's daemon), 17 (the serving control plane). Each runs as
chip_smoke.main runs it, behind what it needs and no more: the kernels'
build; for 13 the one-rank run of phase 9's llama 1b cut (its 13a
reference); for 14 and 16 phase 2's losses (the main path's MAIN_STEPS
steps); 17 runs without 5b's readings beside its own. --root picks the checkout whose package and chip_smoke.py run
(default: this one), so two trees compare on one card in one call
(parent, change). Prints one JSON line: each phase's wall seconds (the
phase function alone) and its own wall breakdown.

    python3 scripts/torch_phase_times.py [--root DIR] [--label NAME]
        [--phases 4 5 6 7 12 13 14 16 17]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    p.add_argument("--phases", type=int, nargs="+", default=[12, 13, 16])
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the phases run on the card")
    import chip_smoke as cs

    smi, att = cs.build_kernels(torch)
    out = {"label": args.label, "root": args.root, "card": smi,
           "wall_s": {}, "phases": {}}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        got = fn(*a, **kw)
        out["wall_s"][name] = time.perf_counter() - t0
        return got

    if 14 in args.phases or 16 in args.phases:
        losses = cs.phase_main_path(torch, att, cs.MAIN_STEPS)["losses"]
        torch.cuda.empty_cache()
    if 6 in args.phases and 5 not in args.phases:
        raise SystemExit("phase 6 prints phase 5's readings: ask for 5 too")
    if 4 in args.phases:
        out["phases"]["4"] = timed("4", cs.phase_serve, torch, att)["wall"]
        torch.cuda.empty_cache()
    if 5 in args.phases:
        batching = timed("5", cs.phase_batching, torch, att)
        out["phases"]["5"] = batching["wall"]
        torch.cuda.empty_cache()
    if 6 in args.phases:
        out["phases"]["6"] = timed("6", cs.phase_paged, torch, att,
                                   batching)["wall"]
        torch.cuda.empty_cache()
    if 7 in args.phases:
        out["phases"]["7"] = timed("7", cs.phase_moe, torch, att)["wall"]
        torch.cuda.empty_cache()
    if 12 in args.phases:
        pp = timed("12", cs.phase_pp, torch, att)
        out["phases"]["12"] = {"wall": pp["wall"],
                               "layouts": pp["layouts"]}
        torch.cuda.empty_cache()
    if 13 in args.phases:
        one = cs.sp_train(torch, "cuda", cs.smoke_config(cs.FSDP_CONFIG),
                          cs.FSDP_TRAIN, "ring")
        torch.cuda.empty_cache()
        mw = timed("13", cs.phase_multiworker, torch, att, one, {})
        out["phases"]["13"] = {"wall": mw["wall"],
                               "http": mw["serve"]["http"],
                               "cotenancy": {
                                   k: mw["cotenancy"][k] for k in (
                                       "preempt_total", "near_ties",
                                       "contended_single_steps")}}
        torch.cuda.empty_cache()
    if 14 in args.phases:
        seam = timed("14", cs.phase_seam, torch, losses)
        out["phases"]["14"] = {k: seam.get(k) for k in (
            "child_s", "launch_to_first_step_s", "loss_diffs", "child")}
        torch.cuda.empty_cache()
    if 16 in args.phases:
        dmn = timed("16", cs.phase_daemon, torch, losses)
        out["phases"]["16"] = dmn
    if 17 in args.phases:
        out["phases"]["17"] = timed("17", cs.phase_gateway, torch, att)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
