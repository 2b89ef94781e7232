#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py from a chosen checkout, and time them.

Any of the phases 0-18 run as chip_smoke.main runs them, in their order,
behind what they need and no more: the kernels' build (phase 0) always;
phase 2's losses for 14, 15, 16 and 18 (the main path's MAIN_STEPS steps);
phase 5's readings for 6 and 17 (5 must be asked for with 6); phase 9's
one-rank run for 10 and 13 (run here when 9 is not asked for); phase 16
for 18 (its parked checkpoint is 18's). Where the checkout's chip_smoke.py
starts its rank server beside the build and waits for its imports before
phase 1, so does this script. --root picks the checkout whose package and
chip_smoke.py run (default: this one), so two trees compare on one card
in one call (parent, change). Prints one JSON line: each phase's wall
seconds (the phase function alone) and its own wall breakdown where it
has one.

    python3 scripts/torch_phase_times.py [--root DIR] [--label NAME]
        [--phases 4 5 6 7 12 13 16 18]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
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
    want = set(args.phases)
    if 6 in want and 5 not in want:
        raise SystemExit("phase 6 prints phase 5's readings: ask for 5 too")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the phases run on the card")
    import chip_smoke as cs

    out = {"label": args.label, "root": args.root, "wall_s": {},
           "phases": {}}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        got = fn(*a, **kw)
        out["wall_s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return got

    server = hasattr(cs, "start_rank_server")
    if server:
        cs.start_rank_server()
    handoff = tempfile.mkdtemp(prefix="phase-times-18-")
    try:
        smi, att = timed("0", cs.build_kernels, torch)
        if server:
            timed("rank_server_wait", cs.await_rank_server)
        out["card"] = smi
        if 1 in want:
            timed("1", cs.phase_kernels, torch, att)
        if want & {2, 14, 15, 16, 18}:
            m = timed("2", cs.phase_main_path, torch, att, cs.MAIN_STEPS)
            losses = m["losses"]
        if 3 in want:
            timed("3", cs.phase_resume)
        if 4 in want:
            out["phases"]["4"] = timed("4", cs.phase_serve, torch,
                                       att)["wall"]
        if want & {5, 17}:
            batching = timed("5", cs.phase_batching, torch, att)
            out["phases"]["5"] = batching["wall"]
        if 6 in want:
            out["phases"]["6"] = timed("6", cs.phase_paged, torch, att,
                                       batching)["wall"]
        if 7 in want:
            out["phases"]["7"] = timed("7", cs.phase_moe, torch,
                                       att)["wall"]
        if 8 in want:
            out["phases"]["8"] = timed("8", cs.phase_sp, torch,
                                       att)["wall"]
        if want & {9, 10, 13}:
            if 9 in want:
                fsdp = timed("9", cs.phase_fsdp, torch, att)
                out["phases"]["9"] = fsdp["wall"]
                one = fsdp["one_rank"]
            else:
                one = cs.sp_train(torch, "cuda",
                                  cs.smoke_config(cs.FSDP_CONFIG),
                                  cs.FSDP_TRAIN, "ring")
        if 10 in want:
            out["phases"]["10"] = timed("10", cs.phase_tp, torch, att,
                                        one=one)["wall"]
        if 11 in want:
            out["phases"]["11"] = timed("11", cs.phase_ep, torch,
                                        att)["wall"]
        if 12 in want:
            pp = timed("12", cs.phase_pp, torch, att)
            out["phases"]["12"] = {"wall": pp["wall"],
                                   "layouts": pp["layouts"]}
        if 13 in want:
            mw = timed("13", cs.phase_multiworker, torch, att, one, {})
            out["phases"]["13"] = {
                "wall": mw["wall"], "http": mw["serve"]["http"],
                "cotenancy": {k: mw["cotenancy"][k] for k in (
                    "preempt_total", "near_ties",
                    "contended_single_steps")}}
        if 14 in want:
            seam = timed("14", cs.phase_seam, torch, losses)
            out["phases"]["14"] = {k: seam.get(k) for k in (
                "child_s", "launch_to_first_step_s", "loss_diffs",
                "child")}
        if 15 in want:
            svc = timed("15", cs.phase_services, torch, losses)
            out["phases"]["15"] = {"phase_s": svc["phase_s"]}
        if want & {16, 18}:
            kw = {"handoff": handoff} if 18 in want else {}
            dmn = timed("16", cs.phase_daemon, torch, losses, **kw)
            out["phases"]["16"] = dmn
        if 17 in want:
            out["phases"]["17"] = timed("17", cs.phase_gateway, torch, att,
                                        batching)
        if 18 in want:
            out["phases"]["18"] = timed(
                "18", cs.phase_fleet, torch, losses,
                {"dir": handoff, "step": dmn["handoff_step"]})
    finally:
        if server:
            cs.stop_rank_server()
        import shutil
        shutil.rmtree(handoff, ignore_errors=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
