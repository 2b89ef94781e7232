#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py from a chosen checkout, and time them.

The phases, in their order in the script: 12 (pp), 13 (multi-worker
grants), 16 (the port's daemon). Each runs as chip_smoke.main runs it,
behind what it needs and no more: the kernels' build; for 13 the one-rank
run of phase 9's llama 1b cut (its 13a reference); for 16 phase 2's
losses (the main path's MAIN_STEPS steps). --root picks the checkout whose
package and chip_smoke.py run (default: this one), so two trees compare on
one card in one call (parent, change). Prints one JSON line: each phase's
wall seconds (the phase function alone) and its own wall breakdown.

    python3 scripts/torch_phase_times.py [--root DIR] [--label NAME]
        [--phases 12 13 16]
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

    if 16 in args.phases:
        losses = cs.phase_main_path(torch, att, cs.MAIN_STEPS)["losses"]
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
    if 16 in args.phases:
        dmn = timed("16", cs.phase_daemon, torch, losses)
        out["phases"]["16"] = dmn
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
