"""Thread-safe metrics registry rendering Prometheus text exposition.

The JAX control plane's obs/metrics.py, cut to the instruments the node
layer and the services feed: the guarded backend's op latency
(backend/guard.py), the scheduler's grant latency (schedulers/gpu.py), the
WAL's group-commit flushes (store/mvcc.py), the store's synchronous writes
(store/client.py), the rolling replace's downtime windows
(utils/copyfast.py) and the span count (obs/trace.py). Names, label shapes
and buckets are the JAX daemon's, so a dashboard reads either.
"""

from __future__ import annotations

import threading

def _fmt(v) -> str:
    """Prometheus sample value: integral floats render as ints."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def escape_label(v) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{k}="{escape_label(v)}"' for k, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """A name, a TYPE, a HELP line, fixed label names, and a lock-guarded
    child table keyed by label-value tuples."""

    typ = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _key(self, labelkw: dict) -> tuple:
        if set(labelkw) != set(self.labels):
            raise ValueError(
                f"{self.name}: labels {sorted(labelkw)} != declared "
                f"{sorted(self.labels)}")
        return tuple(labelkw[k] for k in self.labels)

    def header(self) -> list[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.typ}")
        return out

    def render(self) -> list[str]:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic counter; labeled when `labels` is non-empty."""

    typ = "counter"

    def inc(self, n: float = 1, **labelkw) -> None:
        key = self._key(labelkw)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + n

    def render(self) -> list[str]:
        out = self.header()
        with self._lock:
            items = sorted(self._children.items())
        if not self.labels:
            out.append(f"{self.name} {_fmt(items[0][1] if items else 0)}")
            return out
        for key, v in items:
            out.append(f"{self.name}{_labels_str(self.labels, key)} "
                       f"{_fmt(v)}")
        return out


#: default latency buckets (milliseconds)
LATENCY_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000)


class Histogram(_Instrument):
    """Fixed-bucket histogram with _sum/_count, cumulative on render (bucket
    counts are le-cumulative and +Inf equals _count)."""

    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_MS):
        super().__init__(name, help, labels)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = b

    def observe(self, v: float, **labelkw) -> None:
        key = self._key(labelkw)
        idx = 0
        for bound in self.buckets:          # ~12 floats: scan beats bisect
            if v <= bound:
                break
            idx += 1
        with self._lock:
            child = self._children.get(key)
            if child is None:
                # [per-bucket counts..., overflow, sum, count]
                child = [0] * (len(self.buckets) + 1) + [0.0, 0]
                self._children[key] = child
            child[idx] += 1
            child[-2] += v
            child[-1] += 1

    def snapshot(self, **labelkw) -> dict:
        """{bucketBound: cumulativeCount}, plus sum/count — for tests and
        readings, not for rendering."""
        key = self._key(labelkw)
        with self._lock:
            child = self._children.get(key)
            child = list(child) if child else \
                [0] * (len(self.buckets) + 1) + [0.0, 0]
        cum, out = 0, {}
        for bound, n in zip(self.buckets, child):
            cum += n
            out[bound] = cum
        return {"buckets": out, "inf": cum + child[len(self.buckets)],
                "sum": child[-2], "count": child[-1]}

    def render(self) -> list[str]:
        out = self.header()
        n_cells = len(self.buckets) + 1
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._children.items())
        if not items and not self.labels:
            items = [((), [0] * n_cells + [0.0, 0])]
        for key, child in items:
            cum = 0
            for bound, n in zip(self.buckets, child):
                cum += n
                le = 'le="' + _fmt(bound) + '"'
                out.append(f"{self.name}_bucket"
                           f"{_labels_str(self.labels, key, le)} {cum}")
            cum += child[len(self.buckets)]
            inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{_labels_str(self.labels, key, inf)} {cum}")
            out.append(f"{self.name}_sum{_labels_str(self.labels, key)} "
                       f"{_fmt(round(child[-2], 6))}")
            out.append(f"{self.name}_count{_labels_str(self.labels, key)} "
                       f"{child[-1]}")
        return out


class Registry:
    """Instrument table; render() emits every instrument in registration
    order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            if inst.name in self._instruments:
                raise ValueError(f"metric {inst.name} already registered")
            self._instruments[inst.name] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self.register(Counter(name, help, labels))  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self.register(Histogram(name, help, labels, buckets))  # type: ignore[return-value]

    def render(self) -> str:
        with self._lock:
            instruments = list(self._instruments.values())
        lines: list[str] = []
        for inst in instruments:
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"


# ---- process-global instruments of the node layer and the services -------

REGISTRY = Registry()

BACKEND_OP_LATENCY = REGISTRY.histogram(
    "tdapi_backend_op_duration_ms",
    "GuardedBackend op latency incl. retries/backoff (guard.py)",
    labels=("op",))

GRANT_LATENCY = REGISTRY.histogram(
    "tdapi_sched_grant_duration_ms",
    "card scheduler grant latency: whole-card placement vs share-ledger "
    "bin-packing (schedulers/gpu.py)",
    labels=("kind",),
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100))

WAL_FLUSH_LATENCY = REGISTRY.histogram(
    "tdapi_wal_flush_duration_ms",
    "group-commit leader flush+fsync batches (store/mvcc.py)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250))

STORE_PUT_LATENCY = REGISTRY.histogram(
    "tdapi_store_put_duration_ms",
    "synchronous store writes as callers see them: group-commit wait "
    "included (store/client.py)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250))

REPLACE_DOWNTIME = REGISTRY.histogram(
    "tdapi_replace_downtime_window_ms",
    "rolling-replace stop->start windows (the cards-idle time); the "
    "last-value gauge tdapi_replace_downtime_ms stays for dashboards",
    buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000))

SPANS_TOTAL = REGISTRY.counter(
    "tdapi_trace_spans_total",
    "spans recorded by every trace collector in this process")
