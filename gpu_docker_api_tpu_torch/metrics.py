"""The port's copy of the one metric its workloads observe: the
co-tenancy regulator's device-chunk histogram (gpu_docker_api_tpu/obs/
metrics.py's REGULATOR_CHUNK, same name, help and buckets).

Histogram keeps the JAX package's cells: fixed upper bounds, a count per
bucket plus one overflow cell, the sum and the count (snapshot()).
"""

from __future__ import annotations

import threading


class Histogram:
    """A fixed-bucket histogram with _sum and _count (no labels)."""

    def __init__(self, name: str, help: str, buckets: tuple):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Zero every cell (tests)."""
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def observe(self, v: float) -> None:
        idx = 0
        for bound in self.buckets:          # a dozen floats: scan
            if v <= bound:
                break
            idx += 1
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """{"buckets": per-bucket counts (the last one the overflow),
        "sum", "count"}."""
        with self._lock:
            return {"buckets": list(self._counts), "sum": self._sum,
                    "count": self._count}


REGULATOR_CHUNK = Histogram(
    "tdapi_regulator_chunk_duration_ms",
    "device-chunk slice times through the co-tenancy regulator "
    "(regulator.py) — the preemption stall bound is one chunk",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100))
