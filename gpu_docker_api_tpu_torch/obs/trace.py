"""Causal tracing: span trees over the node layer's stages.

The JAX control plane's obs/trace.py cut to what the node layer calls:
child spans of the current context (`span`, the scheduler's grants and
the store's writes), and a captured context resumed on another thread
(`capture` / `resume`, the write-behind queue's drainer). A root comes
from `root_span` over a TraceCollector, an in-memory ring of traces; the
W3C traceparent ingress, crash stitching and the traces.jsonl writer come
with the REST slice, and so does the operator's on/off switch. With no
root installed a span costs one ContextVar read.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
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
                 "_root", "_finished")

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
        self._root = root
        self._finished = False

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
        return out

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        self.collector.record_span(self)


_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tdapi_span", default=None)


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
