"""Causal tracing: span trees over the node layer's and the services' stages.

The JAX control plane's obs/trace.py cut to what the node layer and the
services call: child spans of the current context (`span`, and the
`traced` method decorator, which labels the span from an argument), a
captured context resumed on another thread (`capture` / `resume`, the
write-behind queue's drainer), and a non-lexical span installed by
`start` and closed by `finish` (an intent from begin() to done()). So a
service call nests as svc.* -> intent.* -> backend.* -> sched.*, the tree
JAX's daemon serves. Spans carry point-in-time events (intent steps,
backend retries, breaker rejections). A root comes from `root_span` over
a TraceCollector, an in-memory ring of traces; the W3C traceparent
ingress, crash stitching (`resume_trace`) and the traces.jsonl writer
come with the REST slice and the reconciler, and so does the operator's
on/off switch. With no root installed a span costs one ContextVar read.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import inspect
import os
import random
import threading
import time
from typing import Iterator, Optional

from . import metrics as _metrics

# ids are correlation handles, not secrets: a seeded PRNG under a lock
_id_rand = random.Random(os.urandom(16))
_id_lock = threading.Lock()


def new_trace_id() -> str:
    with _id_lock:
        return f"{_id_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    with _id_lock:
        return f"{_id_rand.getrandbits(64):016x}"


class Span:
    """One timed stage. Mutable only from the thread that runs it; the
    collector copies it into a plain dict at finish."""

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
        """A point-in-time marker inside this span; `t` is ms since the
        span started."""
        e = {"name": name,
             "t": round((time.perf_counter() - self._t0) * 1e3, 3)}
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
        if self._finished:
            return
        self._finished = True
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        self.collector.record_span(self)


_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tdapi_span", default=None)


def current_trace_id() -> str:
    s = _current.get()
    return s.trace_id if s is not None else ""


def current_ids() -> tuple[str, str]:
    """(trace_id, span_id) of the current span, or ("", ""): what
    intents.begin() journals for the request."""
    s = _current.get()
    return (s.trace_id, s.span_id) if s is not None else ("", "")


@contextlib.contextmanager
def _installed(s: Span) -> Iterator[Span]:
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
def root_span(collector: Optional["TraceCollector"], op: str,
              target: str = "", **attrs) -> Iterator[Optional[Span]]:
    """Open a trace root; finishing it finalizes the trace."""
    if collector is None:
        yield None
        return
    with _installed(Span(collector, new_trace_id(), None, op, target, attrs,
                         root=True)) as s:
        yield s


@contextlib.contextmanager
def span(op: str, target: str = "", **attrs) -> Iterator[Optional[Span]]:
    """Child span of the current context; a no-op with no current span."""
    parent = _current.get()
    if parent is None:
        yield None
        return
    with _installed(Span(parent.collector, parent.trace_id, parent.span_id,
                         op, target, attrs)) as s:
        yield s


def traced(op: str, target: str = ""):
    """Method decorator: run the call inside ``span(op)``. `target` names
    the parameter that labels the span, directly (``"name"``) or one
    attribute deep for a DTO argument (``"req.replicaSetName"``). With no
    current span the wrapper costs one ContextVar read."""
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
    """Open a non-lexical child span and install it as current; pair with
    finish(). The previous current span is restored from the span itself,
    so begin and done may live in different frames of one thread."""
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
    """The current span, for handing to another thread (the write-behind
    queue's submit captures; its drainer resumes)."""
    return _current.get()


@contextlib.contextmanager
def resume(parent: Optional[Span], op: str, target: str = "",
           **attrs) -> Iterator[Optional[Span]]:
    """Child span of a captured context, on whatever thread runs it."""
    if parent is None:
        yield None
        return
    with _installed(Span(parent.collector, parent.trace_id, parent.span_id,
                         op, target, attrs)) as s:
        yield s


class TraceCollector:
    """Bounded in-memory ring of traces, oldest evicted first."""

    def __init__(self, capacity: int = 512,
                 max_spans_per_trace: int = 2048):
        self._lock = threading.Lock()
        self.capacity = max(8, capacity)
        self.max_spans_per_trace = max_spans_per_trace
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.spans_total = 0
        self.traces_dropped = 0

    def record_span(self, span: Span) -> None:
        sj = span.to_json()
        with self._lock:
            self.spans_total += 1
            t = self._traces.get(span.trace_id)
            if t is None:
                t = self._traces[span.trace_id] = {
                    "traceId": span.trace_id, "rootOp": "", "target": "",
                    "durationMs": 0.0, "status": "", "spans": []}
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
                    self.traces_dropped += 1
            if len(t["spans"]) < self.max_spans_per_trace:
                t["spans"].append(sj)
            if span._root:
                t.update(rootOp=span.op, target=span.target,
                         durationMs=round(span.duration_ms, 3),
                         status=span.outcome)
        _metrics.SPANS_TOTAL.inc()

    def get(self, trace_id: str) -> Optional[dict]:
        """A trace's summary and its flat span list."""
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            return {**t, "spans": [dict(s) for s in t["spans"]]}
