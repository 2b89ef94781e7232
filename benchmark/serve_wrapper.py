#!/usr/bin/env python3
"""Starts the program's server (workloads/serve.py of the port) for a
serving cell, under the benchmark's own switches:

- the model is the configuration file's, registered among the port's
  named configs under the configuration's name before serve.main parses
  --config;
- with --bench-trace 1 the batcher's scheduler thread runs a profiler:
  SIGUSR1 starts it, the first SIGUSR2 closes the traced window and stops
  it, the second reads its events and writes the summary
  (devtrace.summarize) to <out>/trace.json; each happens on that thread,
  between two ticks, and the tracer is started once before serving so
  that its own start-up falls in set-up;
- --bench-fault token alters the first token of every answer where the
  batcher produces it (the check must then fail);
- on exit it writes to <out>/stats.json the card's peak allocation and
  the JAX modules this process loaded (run.forbidden_modules), which the
  run refuses as it refuses its own.

    python3 benchmark/serve_wrapper.py --bench-config F --bench-name N \
        --bench-out DIR [--bench-trace 1] -- <serve.py arguments>
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class TraceSwitch:
    """Signals set wishes; the scheduler thread carries them out."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.signals = 0
        self.stage = 0          # 0 idle, 1 tracing, 2 window closed, 3 done
        self.prof = self.window = None
        self.launches = {}
        signal.signal(signal.SIGUSR1, self._on_start)
        signal.signal(signal.SIGUSR2, self._on_mark)

    def _on_start(self, *_):
        self.signals = max(self.signals, 1)

    def _on_mark(self, *_):
        self.signals = max(self.signals + 1, 2)

    def poll(self) -> None:
        if self.stage == self.signals or self.stage == 3:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        import devtrace
        from gpu_docker_api_tpu_torch.ops import attention as att
        if self.stage == 0 and self.signals >= 1:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.window = record_function(devtrace.WINDOW)
            self.window.__enter__()
            att.reset_launches()
            self.stage = 1
        if self.stage == 1 and self.signals >= 2:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.window.__exit__(None, None, None)
            self.launches = dict(att.LAUNCHES)
            # stopping is quick; the events are read at the next stage,
            # once the window's requests have all been answered
            self.prof.__exit__(None, None, None)
            self.stage = 2
        if self.stage == 2 and self.signals >= 3:
            summary = devtrace.from_profiler(self.prof)
            summary["launches"] = self.launches
            _write(os.path.join(self.out_dir, "trace.json"), summary)
            self.prof = None
            self.stage = 3


def warm_profiler() -> None:
    """One empty profiling session, so that the tracer's own start-up is
    paid before serving and not inside the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])):
        torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()


def _write(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--bench-config", required=True)
    p.add_argument("--bench-name", required=True)
    p.add_argument("--bench-out", required=True)
    p.add_argument("--bench-trace", type=int, default=0)
    p.add_argument("--bench-fault", default="")
    args = p.parse_args(argv[:cut])
    serve_args = argv[cut + 1:]
    for path in (BENCH_DIR, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    from program import family_name, port_config
    from reference.spec import load

    spec = load(args.bench_config, args.bench_name)
    from gpu_docker_api_tpu_torch.models import NAMED_CONFIGS
    from gpu_docker_api_tpu_torch.workloads import serve
    NAMED_CONFIGS[family_name(spec)][args.bench_name] = (
        lambda: port_config(spec))

    if args.bench_trace:
        warm_profiler()
        switch = TraceSwitch(args.bench_out)
        tick = serve._Batcher._tick

        def traced_tick(self):
            switch.poll()
            return tick(self)
        serve._Batcher._tick = traced_tick
    if args.bench_fault == "token":
        finish = serve._Batcher._finish

        def altered_finish(self, i, item):
            item["stream"][0] = (item["stream"][0] + 1) % spec.vocab
            return finish(self, i, item)
        serve._Batcher._finish = altered_finish
    elif args.bench_fault:
        raise SystemExit(f"unknown fault {args.bench_fault!r}")

    rc = serve.main(serve_args + ["--family", family_name(spec),
                                  "--config", args.bench_name])
    import torch
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else 0)
    from run import forbidden_modules
    _write(os.path.join(args.bench_out, "stats.json"),
           {"memory_peak_bytes": int(peak), "forbidden": forbidden_modules()})
    return rc


if __name__ == "__main__":
    sys.exit(main())
