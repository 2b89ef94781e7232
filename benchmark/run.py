#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix; the traffic mix's `kind` picks the driver
(drivers/<kind>.py). The driver builds the program (the PyTorch port) from
the configuration file, sets it up, warms it up, measures for --seconds,
and then checks what the timed path produced against the plain reference
(reference/). With --trace 0 the result carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a profiled
window by metrics/<name>.py.

The run refuses (exit 2, no result) without a CUDA card, with fewer cards
than the cell asks for, and (exit 3) when JAX or the JAX package was
loaded, in this process or in a child process that ran the program. Every cache the program builds goes under .bench_cache/ in the
checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_docker_api_tpu")


def set_environment(root: str = ROOT) -> None:
    """Fixed cache directories inside the checkout, and no JAX from a
    library that would load it by itself."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (BENCH_DIR, root):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, manifest_path: str = "",
             bench_dir: str = "", **options) -> dict:
    """One run of cell `name`: the result object, checks last."""
    import manifest
    from reference import compare

    c = manifest.cell(name, manifest_path, bench_dir or BENCH_DIR)
    out = manifest.driver(c).run(c, seed, seconds, trace, device, t0,
                                 **options)
    correct, checks = compare.verdict(out["numbers"], c.limits)
    if trace:
        metrics = manifest.per_layer_values(c, out["summary"])
    else:
        units = {m["name"]: m["unit"] for m in c.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items() if k in units}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_kind(device),
           "count": c.workload["chips"] if device == "cuda" else 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["summary"] is not None:
        dev["busy_s"] = out["summary"]["busy_s"]
        dev["window_s"] = out["summary"]["window_s"]
        import devtrace
        result["breakdown"] = devtrace.breakdown(out["summary"])
    result["forbidden"] = out.get("forbidden", [])
    result["reported"] = {k: v for k, v in out["numbers"].items()
                          if k not in c.limits and k != "worst"}
    result["worst"] = out["numbers"].get("worst", {})
    result["timing"] = out.get("timing", {})
    result["checks"] = checks
    return result


def finite(x):
    """x with every non-finite float written as a string, so that the line
    stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def _device_kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()

    import manifest
    c = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.workload["chips"]:
        print(f"{args.workload} needs {c.workload['chips']} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return report(run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace)))


def report(result: dict) -> int:
    """Prints the checks and the result line, or refuses (exit 3, no
    result) where this process or the program's child process loaded JAX
    or the JAX package."""
    found = sorted(set(forbidden_modules()) | set(result.pop("forbidden")))
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
