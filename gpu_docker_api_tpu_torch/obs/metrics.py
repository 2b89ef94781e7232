"""Prometheus exposition: a registry of counters, gauges and histograms.

The port's copy of the JAX control plane's obs/metrics.py. The
co-tenancy regulator's chunk histogram lives in the top-level metrics.py,
which the workloads import on their own; it renders here, in the JAX
registry's place for it.

Instruments are declared once (name, help, type, label names), mutated
from the hot paths with one lock-guarded dict update, and rendered into
the v0.0.4 text format with proper label-value escaping. Names, label
shapes and buckets are the JAX daemon's, so a dashboard reads either.

Two registries exist at runtime:

- the module-level :data:`REGISTRY` holds process-global instruments fed
  by modules that have no App handle (backend/guard.py, store/*,
  regulator.py, utils/copyfast.py, obs/trace.py);
- each App builds its own Registry for the inventory gauges whose truth
  lives on that App's schedulers/queues, refreshed by a collect callback
  at scrape time.

GET /metrics renders both, App-local first. Instrument names for BOTH
are registered in obs/names.py.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import metrics as _workload_metrics

# Hot-path disarm switch, mirroring trace.set_enabled(): an overhead A/B
# flips BOTH so the measured delta prices the whole obs layer (tracing
# and histograms), not just the span half. Gates only Histogram.observe,
# the per-request / per-op distribution instruments on the hot paths;
# counters and gauges stay on.
_enabled = True


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


# ---- value / label formatting -------------------------------------------


def _fmt(v) -> str:
    """Prometheus sample value: integral floats render as ints (the
    pre-registry exposition printed `2`, not `2.0` — tests and dashboards
    match on that)."""
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
    """Shared shape: a name, a TYPE, a HELP line, fixed label names, and
    a lock-guarded child table keyed by label-value tuples."""

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

    def value(self, **labelkw) -> float:
        key = self._key(labelkw)
        with self._lock:
            return self._children.get(key, 0)

    def render(self) -> list[str]:
        out = self.header()
        with self._lock:
            items = sorted(self._children.items())
        if not self.labels:
            # an unlabeled counter always exposes a sample (0 before the
            # first inc), like the pre-registry hand-built lines did
            out.append(f"{self.name} {_fmt(items[0][1] if items else 0)}")
            return out
        for key, v in items:
            out.append(f"{self.name}{_labels_str(self.labels, key)} "
                       f"{_fmt(v)}")
        return out


class Gauge(_Instrument):
    """Set-valued instrument. `typ` may be overridden to "counter" for
    series whose VALUE is a monotonic count owned elsewhere (workqueue
    coalesced, breaker failures) — the registry renders it, the owner
    counts it. reset() drops all children; collect callbacks that emit
    per-entity lines (per-chip shares, per-chip regulators) call it first
    so departed entities don't linger as stale series."""

    typ = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = (), typ: str = "gauge"):
        super().__init__(name, help, labels)
        self.typ = typ

    def set(self, v, **labelkw) -> None:
        key = self._key(labelkw)
        with self._lock:
            self._children[key] = v

    def reset(self) -> None:
        with self._lock:
            self._children.clear()

    def render(self) -> list[str]:
        out = self.header()
        with self._lock:
            items = sorted(self._children.items(), key=lambda kv: [
                str(x) for x in kv[0]])
        if not self.labels:
            out.append(f"{self.name} {_fmt(items[0][1] if items else 0)}")
            return out
        for key, v in items:
            out.append(f"{self.name}{_labels_str(self.labels, key)} "
                       f"{_fmt(v)}")
        return out


#: default latency buckets (milliseconds): sub-ms store writes up to
#: multi-second replaces
LATENCY_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000)


class Histogram(_Instrument):
    """Fixed-bucket histogram with _sum/_count, cumulative on render (the
    Prometheus contract: bucket counts are le-cumulative and +Inf equals
    _count). observe() is the hot path: one bucket scan over a dozen
    floats + two adds under the lock."""

    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_MS):
        super().__init__(name, help, labels)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = b
        # external shard source (cross-process telemetry): a callable
        # returning {label_tuple: (bucket_counts, sum, count)} merged into
        # the in-process children at render/snapshot time. This is how the
        # worker tier's shared-memory metric shards feed the SAME family
        # the in-process path observes into (obs/shm_metrics.py) — one
        # truthful tdapi_gateway_request_duration_ms whether a request was
        # served by the daemon or a worker process. bucket_counts must use
        # THIS histogram's bucket layout plus one overflow cell.
        self._extern = None

    def set_extern(self, fn) -> None:
        """Install (or clear, fn=None) the external shard source."""
        self._extern = fn

    def _extern_children(self) -> dict:
        fn = self._extern
        if fn is None:
            return {}
        try:
            return dict(fn())
        # a scrape must render even when the shard segment is mid-teardown;
        # the in-process children still render
        except Exception:  # noqa: BLE001
            return {}

    @staticmethod
    def _merge_child(child: list, ext, n_cells: int) -> None:
        counts, total, count = ext
        for i, n in enumerate(counts[:n_cells]):
            child[i] += n
        child[-2] += total
        child[-1] += count

    def observe(self, v: float, **labelkw) -> None:
        if not _enabled:
            return
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
        bench assertions, not for rendering. Includes external shard data
        (set_extern) so the view matches what /metrics renders."""
        key = self._key(labelkw)
        extern = self._extern_children()
        with self._lock:
            child = self._children.get(key)
            child = list(child) if child else \
                [0] * (len(self.buckets) + 1) + [0.0, 0]
        if key in extern:
            self._merge_child(child, extern[key], len(self.buckets) + 1)
        cum, out = 0, {}
        for bound, n in zip(self.buckets, child):
            cum += n
            out[bound] = cum
        return {"buckets": out, "inf": cum + child[len(self.buckets)],
                "sum": child[-2], "count": child[-1]}

    def render(self) -> list[str]:
        out = self.header()
        extern = self._extern_children()
        n_cells = len(self.buckets) + 1
        with self._lock:
            merged = {k: list(v) for k, v in self._children.items()}
        for key, ext in extern.items():
            child = merged.get(key)
            if child is None:
                child = merged[key] = [0] * n_cells + [0.0, 0]
            self._merge_child(child, ext, n_cells)
        items = sorted(merged.items())
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


class _Adopted(Histogram):
    """Renders a top-level metrics.Histogram (unlabeled; its snapshot's
    per-bucket counts end with the overflow cell) as this family."""

    def __init__(self, source) -> None:
        super().__init__(source.name, source.help, (), source.buckets)
        self.source = source

    def render(self) -> list[str]:
        snap = self.source.snapshot()
        with self._lock:
            self._children = {(): snap["buckets"] + [snap["sum"],
                                                     snap["count"]]}
        return super().render()


class Registry:
    """Instrument table + collect hooks. render() runs the hooks (owners
    refresh gauges from live state), then emits every instrument in
    registration order — stable output, stable diffs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: list[Callable[[], None]] = []

    def register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            if inst.name in self._instruments:
                raise ValueError(f"metric {inst.name} already registered")
            self._instruments[inst.name] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self.register(Counter(name, help, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = (), typ: str = "gauge") -> Gauge:
        return self.register(Gauge(name, help, labels, typ))  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self.register(Histogram(name, help, labels, buckets))  # type: ignore[return-value]

    def collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
            instruments = list(self._instruments.values())
        for fn in collectors:
            fn()
        lines: list[str] = []
        for inst in instruments:
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"


# ---- process-global instruments -----------------------------------------
# Fed by modules with no App handle; App renders this registry after its
# own. Names are in obs/names.py (tdlint untraced-op checks both sides).

REGISTRY = Registry()

REQUEST_LATENCY = REGISTRY.histogram(
    "tdapi_http_request_duration_ms",
    "request latency through the full stack, labeled by route PATTERN "
    "(bounded cardinality), not raw path",
    labels=("method", "route"))

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

REGULATOR_CHUNK = REGISTRY.register(
    _Adopted(_workload_metrics.REGULATOR_CHUNK))

SPANS_TOTAL = REGISTRY.counter(
    "tdapi_trace_spans_total",
    "spans recorded by every trace collector in this process")

GATEWAY_LATENCY = REGISTRY.histogram(
    "tdapi_gateway_request_duration_ms",
    "gateway data-plane latency: admission wait + replica forward + "
    "relay, per gateway (gateway.py)",
    labels=("gateway",),
    buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
             10000))

GATEWAY_SCALE_READY = REGISTRY.histogram(
    "tdapi_gateway_scale_ready_ms",
    "autoscale trigger -> new replica READY (serving /healthz): the "
    "CoW-clone + warm-pool path this distribution prices against a cold "
    "start",
    labels=("gateway",),
    buckets=(25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000))
