#!/usr/bin/env python3
"""Readings for setting a cell's correctness limits, on the card.

    python3 benchmark/control.py --workload W --seeds 1 2 3 \
        [--mode program|control|fault:<name>] [--seconds S] [--out F]

For each seed, one run of the cell's driver, the numbers its comparison
gives and the verdict of the cell's limits on them, printed as one JSON
line (and appended to --out):

- program: the program as the benchmark runs it (the lower readings);
- control: the plain reference in float8 put in the program's place (for
  a served model: the tokens the reference's float8 forward puts first at
  each position of the same prompts and served tokens), the upper
  readings;
- fault:<name>: the program with a planted fault (drivers/train.FAULTS,
  or "token" for serving), which the check must fail.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    run.set_environment()
    import manifest
    from reference import compare

    options = {}
    if args.mode == "control":
        options["control"] = True
    elif args.mode.startswith("fault:"):
        options["fault"] = args.mode.split(":", 1)[1]
    elif args.mode != "program":
        p.error(f"mode {args.mode!r}")
    c = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = manifest.driver(c).run(c, seed, args.seconds, False,
                                     args.device, t0, **options)
        line = {"workload": args.workload, "mode": args.mode, "seed": seed,
                "correct": compare.verdict(out["numbers"], c.limits)[0],
                "numbers": out["numbers"], "timing": out.get("timing"),
                "e2e": out["e2e"], "failed": out["failed"],
                "readings": out.get("readings")}
        text = json.dumps(run.finite(line))
        print(text, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
