"""Causal tracing: W3C traceparent in, span trees out.

Model (a deliberately small subset of OpenTelemetry's):

- a **trace** is one logical operation end-to-end, identified by a 32-hex
  trace id. The id comes from the client's `traceparent` header when
  present (W3C Trace Context level 1), else is minted at HTTP ingress —
  so a caller that spans several control planes can stitch them.
- a **span** is one timed stage inside it (ingress, service call, intent
  lifetime, backend op, scheduler grant, store write, workqueue drain,
  layer copy), with a parent span, attributes, and point-in-time
  **span events** (intent steps, backend retries, breaker rejections).

Propagation is contextvars-based: the ingress root is installed as the
current span for the request thread; `span()` children nest lexically;
`capture()`/`resume()` carry the context onto OTHER threads (the
workqueue drainer, guard deadline workers); `start()`/`finish()` bracket
non-lexical lifetimes (an intent from begin() to done()). Work that runs
with no root installed — unit tests poking a service directly, the
regulator's hot loop — pays one ContextVar read and nothing else.

Finished spans land in the owning TraceCollector: a bounded in-memory
ring of traces (served at GET /api/v1/traces) plus traces.jsonl (size-
rotated, obs/rotate.py). Retention is **keep-slowest**: the ring holds
the most recent `capacity` traces, but up to `keep_slowest` of the
slowest-rooted traces ever seen are pinned past FIFO eviction — the p99
outlier from an hour ago is exactly the trace an operator comes looking
for, and a busy daemon would have FIFO'd it out in seconds.

Crash stitching: intents.begin() folds the current trace/span ids into
the journaled record (like idemKey); the boot reconciler replays the
interrupted mutation under `resume_trace()` with those SAME ids, so
GET /api/v1/traces/{traceId} after a crash shows the recovery spans on
the original request's trace.

Overhead: a span is two perf_counter reads, one dict, and a lock-guarded
list append at finish; TDAPI_TRACE=0 (or set_enabled(False)) turns every
entry point into a ContextVar read + None check. bench.py measures the
armed-vs-disarmed difference as obs_overhead_pct (criterion: <= 5% on
the c16 scheduling sweep).

The port's copy of the JAX control plane's obs/trace.py.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import inspect
import json
import os
import random
import threading
import time
from typing import Iterator, Optional

from . import metrics as _metrics
from .rotate import RotatingWriter

TRACE_ENV = "TDAPI_TRACE"


def _env_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "1").lower() not in ("0", "false", "no")


_enabled = _env_enabled()


def set_enabled(on: bool) -> None:
    """Arm/disarm tracing process-wide (bench's A/B switch; the env knob
    TDAPI_TRACE=0 sets the boot default)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


# ---- W3C traceparent (level 1): 00-<32hex trace>-<16hex span>-<2hex flags>

# id entropy: a process-seeded PRNG, NOT os.urandom per id — ids are
# correlation handles, not secrets, and on syscall-taxed kernels (gVisor)
# urandom costs ~15us per call, which at ~20 spans per mutation was the
# single largest line in obs_overhead_pct. Lock-guarded: getrandbits on a
# shared Random is not atomic across threads.
_id_rand = random.Random(os.urandom(16))
_id_lock = threading.Lock()


def new_trace_id() -> str:
    with _id_lock:
        return f"{_id_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    with _id_lock:
        return f"{_id_rand.getrandbits(64):016x}"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a traceparent header, or None on
    anything malformed — a bad header must never fail the request, the
    trace just restarts here."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# ------------------------------------------------------------------ spans

class Span:
    """One timed stage. Mutable only from the thread that runs it; the
    collector copies it into plain dicts at finish."""

    __slots__ = ("collector", "trace_id", "span_id", "parent_id", "op",
                 "target", "start", "_t0", "duration_ms", "outcome", "attrs",
                 "events", "_root", "_prev", "_finished")

    def __init__(self, collector: "TraceCollector", trace_id: str,
                 parent_id: Optional[str], op: str, target: str,
                 attrs: dict, root: bool = False):
        self.collector = collector
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.op = op
        self.target = target
        self.start = round(time.time(), 6)
        self._t0 = time.perf_counter()
        self.duration_ms = 0.0
        self.outcome = "ok"
        self.attrs = attrs
        self.events: list[dict] = []
        self._root = root
        self._prev: Optional[Span] = None
        self._finished = False

    def event(self, name: str, **attrs) -> None:
        """Point-in-time marker inside this span (intent step, backend
        retry, breaker rejection); `t` is ms since the span started."""
        e = {"name": name,
             "t": round((time.perf_counter() - self._t0) * 1e3, 3)}
        if attrs:
            e.update(attrs)
        self.events.append(e)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_json(self) -> dict:
        out = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "op": self.op,
            "target": self.target,
            "start": self.start,
            "durationMs": round(self.duration_ms, 3),
            "status": self.outcome,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.events:
            out["events"] = list(self.events)
        return out

    def _finish(self) -> None:
        if self._finished:       # double finish (defensive): first wins
            return
        self._finished = True
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        self.collector.record_span(self)


_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tdapi_span", default=None)


def current() -> Optional[Span]:
    return _current.get()


def current_trace_id() -> str:
    s = _current.get()
    return s.trace_id if s is not None else ""


def current_ids() -> tuple[str, str]:
    """(trace_id, span_id) of the current span, or ("", "") — what
    intents.begin() journals for crash stitching."""
    s = _current.get()
    return (s.trace_id, s.span_id) if s is not None else ("", "")


def event(name: str, **attrs) -> None:
    """Attach a point-in-time event to the current span, if any."""
    s = _current.get()
    if s is not None:
        s.event(name, **attrs)


def annotate(**attrs) -> None:
    s = _current.get()
    if s is not None:
        s.attrs.update(attrs)


@contextlib.contextmanager
def root_span(collector: Optional["TraceCollector"], op: str,
              traceparent: str = "", target: str = "",
              **attrs) -> Iterator[Optional[Span]]:
    """Open a trace root (HTTP ingress). Honors an inbound W3C
    traceparent; finishing the root finalizes the trace (jsonl write +
    retention)."""
    if collector is None or not _enabled:
        yield None
        return
    parsed = parse_traceparent(traceparent)
    if parsed:
        trace_id, parent_id = parsed
    else:
        trace_id, parent_id = new_trace_id(), None
    s = Span(collector, trace_id, parent_id, op, target, attrs, root=True)
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s.outcome = type(e).__name__
        raise
    finally:
        _current.reset(token)
        s._finish()


@contextlib.contextmanager
def span(op: str, target: str = "", **attrs) -> Iterator[Optional[Span]]:
    """Child span of the current context. No current span (bare unit
    tests, disarmed tracing) -> a no-op costing one ContextVar read."""
    parent = _current.get()
    if parent is None:
        yield None
        return
    s = Span(parent.collector, parent.trace_id, parent.span_id, op, target,
             attrs)
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s.outcome = type(e).__name__
        raise
    finally:
        _current.reset(token)
        s._finish()


def traced(op: str, target: str = ""):
    """Method decorator: run the call inside ``span(op)``. `target` names
    the parameter that labels the span — either directly (``"name"``) or
    one attribute deep for DTO args (``"req.replicaSetName"``). When no
    span is current (bare unit tests, disarmed tracing) the wrapper costs
    one ContextVar read and calls straight through."""
    base, _, attr = target.partition(".")

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _current.get() is None:
                return fn(*args, **kwargs)
            tgt = ""
            if base:
                try:
                    v = sig.bind_partial(*args, **kwargs).arguments.get(base)
                except TypeError:
                    v = None
                if v is not None and attr:
                    v = getattr(v, attr, None)
                if v is not None:
                    tgt = str(v)
            with span(op, target=tgt):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def start(op: str, target: str = "", **attrs) -> Optional[Span]:
    """Open a NON-lexical child span (an intent's begin->done lifetime)
    and install it as current. Pair with finish(); the previous current
    span is restored from the span itself, so begin/done may live in
    different stack frames of the same thread."""
    parent = _current.get()
    if parent is None:
        return None
    s = Span(parent.collector, parent.trace_id, parent.span_id, op, target,
             attrs)
    s._prev = parent
    _current.set(s)
    return s


def finish(s: Optional[Span], status: str = "") -> None:
    if s is None:
        return
    if status:
        s.outcome = status
    if _current.get() is s:      # tolerate a finish from an outer frame
        _current.set(s._prev)
    s._finish()


def capture() -> Optional[Span]:
    """The current span, for handing to another thread (workqueue submit
    captures; the drainer resumes)."""
    return _current.get()


@contextlib.contextmanager
def resume(parent: Optional[Span], op: str, target: str = "",
           **attrs) -> Iterator[Optional[Span]]:
    """Child span of a CAPTURED context, on whatever thread runs it —
    how async work-behind stages stay on their originating trace."""
    if parent is None or not _enabled:
        yield None
        return
    s = Span(parent.collector, parent.trace_id, parent.span_id, op, target,
             attrs)
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s.outcome = type(e).__name__
        raise
    finally:
        _current.reset(token)
        s._finish()


@contextlib.contextmanager
def resume_trace(collector: Optional["TraceCollector"], trace_id: str,
                 parent_span_id: str, op: str, target: str = "",
                 **attrs) -> Iterator[Optional[Span]]:
    """Open a root-level span on an EXISTING trace id — the reconciler's
    crash-stitching entry: the intent record carries the original
    request's (traceId, spanId), so replay spans join that trace."""
    if collector is None or not _enabled or not trace_id:
        yield None
        return
    s = Span(collector, trace_id, parent_span_id or None, op, target,
             attrs, root=True)
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s.outcome = type(e).__name__
        raise
    finally:
        _current.reset(token)
        s._finish()


# -------------------------------------------------------------- collector

class _Trace:
    __slots__ = ("trace_id", "spans", "root_op", "target", "start",
                 "duration_ms", "outcome", "done")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[dict] = []
        self.root_op = ""
        self.target = ""
        self.start = 0.0
        self.duration_ms = 0.0
        self.outcome = ""
        self.done = False


class TraceCollector:
    """Bounded trace store + traces.jsonl writer (see module doc for the
    keep-slowest retention contract)."""

    #: jsonl flush cadence — same rationale as EventLog: telemetry, not
    #: state; reads and close() drain the buffered tail
    FLUSH_INTERVAL_S = 1.0

    def __init__(self, state_dir: Optional[str] = None, capacity: int = 512,
                 keep_slowest: int = 64, max_spans_per_trace: int = 2048):
        self._lock = threading.Lock()
        self.capacity = max(8, capacity)
        self.keep_slowest = max(0, min(keep_slowest, self.capacity // 2))
        self.max_spans_per_trace = max_spans_per_trace
        self._traces: dict[str, _Trace] = {}
        self._order: collections.deque = collections.deque()
        self._slow: dict[str, float] = {}     # pinned past FIFO eviction
        self._writer: Optional[RotatingWriter] = None
        #: guards the jsonl writer alone — serialization and file append
        #: happen OUTSIDE self._lock so a large trace finalizing can't
        #: stall every concurrent span finish (see _write_row)
        self._io_lock = threading.Lock()
        self._last_flush = 0.0
        self.spans_total = 0
        self.traces_dropped = 0
        if state_dir:
            self._writer = RotatingWriter(
                os.path.join(state_dir, "traces.jsonl"))

    # ---- write side (span finish) ----

    def record_span(self, span: Span) -> None:
        sj = span.to_json()
        row = None
        with self._lock:
            self.spans_total += 1
            t = self._traces.get(span.trace_id)
            if t is None:
                t = _Trace(span.trace_id)
                self._traces[span.trace_id] = t
                self._order.append(span.trace_id)
            if len(t.spans) < self.max_spans_per_trace:
                t.spans.append(sj)
            if span._root:
                row = self._finalize(t, span.op, span.target, span.start,
                                     span.duration_ms, span.outcome)
        if row is not None:
            self._write_row(row)
        _metrics.SPANS_TOTAL.inc()

    def ingest_row(self, row: dict) -> None:
        """Adopt an externally-produced span dict — the worker span-spool
        merge (obs/spool.py SpoolTailer). ``"root": true`` rows finalize
        their trace exactly like a local root finish, so keep-slowest
        retention and the traces.jsonl record treat worker-served
        data-plane requests like any other trace."""
        row = dict(row)
        is_root = bool(row.pop("root", False))
        trace_id = row.get("traceId")
        if not trace_id:
            return
        out = None
        with self._lock:
            self.spans_total += 1
            t = self._traces.get(trace_id)
            if t is None:
                t = _Trace(trace_id)
                self._traces[trace_id] = t
                self._order.append(trace_id)
            if len(t.spans) < self.max_spans_per_trace:
                t.spans.append(row)
            if is_root:
                out = self._finalize(
                    t, row.get("op", ""), row.get("target", ""),
                    row.get("start", 0.0),
                    float(row.get("durationMs", 0.0)),
                    row.get("status", "ok"))
        if out is not None:
            self._write_row(out)
        _metrics.SPANS_TOTAL.inc()

    def _write_row(self, row: dict) -> None:
        """Serialize + append one traces.jsonl line OUTSIDE the collector
        lock: json.dumps over a big span list is the expensive part of
        finalizing, and under self._lock it would block every concurrent
        span finish in the process. The io lock keeps lines whole."""
        line = json.dumps(row, separators=(",", ":")) + "\n"
        with self._io_lock:
            if self._writer is None:
                return
            self._writer.write(line)
            now = time.monotonic()
            if now - self._last_flush >= self.FLUSH_INTERVAL_S:
                self._writer.flush()
                self._last_flush = now

    def _finalize(self, t: _Trace, op: str, target: str, start: float,
                  duration_ms: float, outcome: str) -> Optional[dict]:
        """Root finished: stamp the trace summary, apply retention, and
        return the jsonl row for the caller to persist off-lock (span
        list SNAPSHOTTED here — spans landing later mutate t.spans under
        the lock). A trace can finalize more than once (runtime reconcile
        joining an old trace id; a worker root merging after a daemon
        one) — later roots update the summary, one line per finalization,
        newest last."""
        t.root_op = op
        t.target = target or t.target
        t.start = start
        t.duration_ms = round(duration_ms, 3)
        t.outcome = outcome
        t.done = True
        row = None
        if self._writer is not None:
            row = {"traceId": t.trace_id, "rootOp": t.root_op,
                   "target": t.target, "start": t.start,
                   "durationMs": t.duration_ms, "status": t.outcome,
                   "spans": list(t.spans)}
        # keep-slowest bookkeeping: pin this trace if it beats the
        # slowest set; a displaced trace rejoins the FIFO eviction queue
        if self.keep_slowest:
            if len(self._slow) < self.keep_slowest:
                self._slow[t.trace_id] = t.duration_ms
            else:
                fastest = min(self._slow, key=self._slow.__getitem__)
                if t.duration_ms > self._slow[fastest]:
                    del self._slow[fastest]
                    self._order.append(fastest)
                    self._slow[t.trace_id] = t.duration_ms
        while len(self._traces) > self.capacity and self._order:
            victim = self._order.popleft()
            if victim in self._slow or victim not in self._traces:
                continue       # pinned (or already gone): not evictable
            del self._traces[victim]
            self.traces_dropped += 1
        return row

    # ---- read side (GET /api/v1/traces) ----

    def list(self, op: str = "", min_duration_ms: float = 0.0,
             limit: int = 100) -> list[dict]:
        """Finished-trace summaries, slowest first (the question this
        endpoint answers is 'what was slow?'); `op` substring-matches the
        root op."""
        with self._lock:
            rows = [
                {"traceId": t.trace_id, "rootOp": t.root_op,
                 "target": t.target, "start": t.start,
                 "durationMs": t.duration_ms, "status": t.outcome,
                 "spanCount": len(t.spans)}
                for t in self._traces.values()
                if t.done and t.duration_ms >= min_duration_ms
                and (not op or op in t.root_op)]
        rows.sort(key=lambda r: -r["durationMs"])
        return rows[:max(0, limit)]

    def get(self, trace_id: str) -> Optional[dict]:
        """Full trace: flat span list plus the assembled tree."""
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            spans = [dict(s) for s in t.spans]
        with self._io_lock:
            if self._writer is not None:   # reads drain the offline tail
                self._writer.flush()
                self._last_flush = time.monotonic()
        return {"traceId": trace_id, "rootOp": t.root_op,
                "target": t.target, "durationMs": t.duration_ms,
                "status": t.outcome, "spans": spans,
                "tree": assemble_tree(spans)}

    def stats(self) -> dict:
        with self._lock:
            return {"retained": len(self._traces),
                    "spansTotal": self.spans_total,
                    "dropped": self.traces_dropped}

    def close(self) -> None:
        with self._io_lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None


def assemble_tree(spans: list[dict]) -> list[dict]:
    """Nest spans by parentId; spans whose parent is outside the set (the
    ingress root's client-side parent, a reconciler resume) become roots.
    Children sort by start time."""
    by_id = {s["spanId"]: {**s, "children": []} for s in spans}
    roots: list[dict] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parentId") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n["start"])
    roots.sort(key=lambda n: n["start"])
    return roots
