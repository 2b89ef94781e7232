#!/usr/bin/env python3
"""The knee of a serving cell: one server, the cell's mix offered at a
series of rates, each for a window, on the card.

    python3 benchmark/sweep.py --workload W --rates 3 4 5 6 --seconds 30

For each rate one JSON line: the requests offered and finished in the
window, the latency p50 / p95 from the due time, how much later the last
third of the window's requests waited than the first third (a backlog that
grows), and what was still in flight at the window's close. The knee is
the highest rate whose completions keep pace with its arrivals. The
benchmark's own runs never run this.
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
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    run.set_environment()
    import manifest
    import stats
    from reference.spec import from_dict

    c = manifest.cell(args.workload)
    srv = manifest.driver(c)
    spec = from_dict(c.config, c.config_name)
    gen = manifest.generator(c)
    server = srv.Server(c, False, args.device)
    try:
        server.wait_ready()
        warm = gen.requests(c.traffic, args.seed, 24 / 4.0, spec.vocab,
                            rate=4.0)
        for r in warm:
            srv.send(server.port, r["prompt"], r["max_new"], 600)
        for i, rate in enumerate(args.rates):
            reqs = gen.requests(c.traffic, args.seed + 1 + i,
                                args.seconds, spec.vocab, rate=rate)
            records, start = srv.offer(server.port, reqs, args.seconds)
            close = start + args.seconds
            ok = [r for r in records if r and r["ok"]]
            lat = [(r["done"] - r["due"]) * 1e3 for r in ok]
            third = max(1, len(ok) // 3)
            line = {
                "rate_per_s": rate, "offered": len(reqs),
                "finished_in_window": sum(1 for r in ok if r["done"] <= close),
                "in_flight_at_close": sum(1 for r in ok if r["done"] > close),
                "failed": len(reqs) - len(ok),
                "latency_p50_ms": stats.percentile(lat, 50),
                "latency_p95_ms": stats.percentile(lat, 95),
                "last_minus_first_third_ms": (
                    stats.percentile(lat[-third:], 50)
                    - stats.percentile(lat[:third], 50)),
                "tokens_per_s": sum(len(q["prompt"]) + q["max_new"]
                                    for q, r in zip(reqs, records)
                                    if r and r["ok"] and r["done"] <= close)
                / args.seconds}
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(text + "\n")
            time.sleep(2.0)
    finally:
        server.stop()
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
