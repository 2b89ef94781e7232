"""Operation event log — the observability the reference lacks.

The port's copy of the JAX control plane's events.py, unchanged.

SURVEY §5.1: the reference has no tracing; its only observability is
leveled logs. Every API request and internal state transition is recorded
as one event with its request id, app code, latency — and, since the obs
subsystem, the TRACE id of whatever request caused it, so an
/api/v1/events row links straight to its span tree at
/api/v1/traces/{traceId}.

Events land in a bounded in-memory ring (served at GET /api/v1/events)
and append to events.jsonl in the state dir for offline analysis; the
file is size-rotated (current + one predecessor, TDAPI_EVENTS_MAX_MB —
obs/rotate.py), so a long-lived daemon's telemetry can't fill the state
volume. Each event carries a monotonically increasing `seq`, which is
the SSE event id: `GET /api/v1/events?follow=1` streams the ring from a
`Last-Event-ID` resume point, and `wait_since()` is the condition-variable
primitive that stream rides on.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Optional

from .obs import trace
from .obs.rotate import RotatingWriter


class EventLog:
    # jsonl flush cadence: events are observability, not state — a
    # per-record flush put a locked disk write on EVERY api request (hot
    # path). Under steady traffic records flush at most once a second;
    # recent() and close() also flush, so tailing /api/v1/events or a
    # graceful stop drains the buffer. The in-memory ring is always
    # current; worst case a CRASH on an idle daemon loses the OFFLINE
    # copy's buffered tail (whatever arrived since the last flush/read).
    FLUSH_INTERVAL_S = 1.0

    def __init__(self, state_dir: Optional[str] = None, capacity: int = 2048):
        self._lock = threading.Lock()
        # SSE followers park on this until a record() moves _seq past
        # their resume point
        self._cond = threading.Condition(self._lock)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._w: Optional[RotatingWriter] = None
        self._last_flush = 0.0
        self._seq = 0
        # optional per-event mirror (obs/recorder.py FlightRecorder
        # note_event): the daemon's flight recorder sees every event the
        # moment it lands, so its SIGTERM/atexit flush carries the final
        # control-plane moments. Called OUTSIDE the log's lock.
        self.mirror = None
        if state_dir:
            self._w = RotatingWriter(f"{state_dir}/events.jsonl")

    def record(self, op: str, target: str = "", code: int = 200,
               duration_ms: float = 0.0, request_id: str = "",
               **extra) -> None:
        evt = {
            "ts": round(time.time(), 4),
            "op": op,
            "target": target,
            "code": code,
            "durationMs": round(duration_ms, 2),
            "requestId": request_id,
        }
        # causal link: any event recorded while a traced request is on
        # this thread inherits its trace id (explicit traceId= wins)
        tid = trace.current_trace_id()
        if tid:
            evt["traceId"] = tid
        if extra:
            evt.update(extra)
        with self._cond:
            self._seq += 1
            evt["seq"] = self._seq
            self._ring.append(evt)
            if self._w is not None:
                self._w.write(json.dumps(evt) + "\n")
                now = time.monotonic()
                if now - self._last_flush >= self.FLUSH_INTERVAL_S:
                    self._w.flush()
                    self._last_flush = now
            self._cond.notify_all()
        mirror = self.mirror
        if mirror is not None:
            try:
                mirror(evt)
            # tdlint: disable=silent-swallow -- best-effort flight-recorder mirror; the event itself already landed in the ring and jsonl
            except Exception:  # noqa: BLE001
                pass

    def recent(self, limit: int = 200, target: str = "") -> list[dict]:
        with self._lock:
            evts = list(self._ring)
            if self._w is not None:     # reads drain the offline buffer
                self._w.flush()
                self._last_flush = time.monotonic()
        if target:
            evts = [e for e in evts if e.get("target") == target]
        return evts[-limit:]

    # ---- follow/streaming surface (SSE; server/app.py h_events) ----

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def first_retained(self) -> int:
        """Oldest seq still in the ring (0 when empty). A Last-Event-ID
        resume below first_retained - 1 has lost events to eviction —
        the SSE stream reports that as an `event: gap` frame instead of
        silently serving the survivors (server/app.py)."""
        with self._lock:
            return self._ring[0]["seq"] if self._ring else 0

    def _newer_than(self, seq: int) -> list[dict]:
        """Ring events with seq > `seq`, oldest first. Caller holds the
        lock. The ring is seq-ordered, so walk it backwards and stop at
        the resume point — a follower that is 1 event behind pays O(1),
        not O(capacity) (the scan runs under the same lock record()
        needs, so this is the hot path's contention)."""
        out: list[dict] = []
        for e in reversed(self._ring):
            if e["seq"] <= seq:
                break
            out.append(e)
        out.reverse()
        return out

    def since(self, seq: int, limit: int = 0) -> list[dict]:
        """Ring events with seq > `seq`, oldest first — the Last-Event-ID
        resume read. A resume point older than the ring's tail simply
        yields everything retained (the gap is visible as a seq jump)."""
        with self._lock:
            out = self._newer_than(seq)
        return out[:limit] if limit else out

    def wait_since(self, seq: int, timeout: float) -> list[dict]:
        """Block until events newer than `seq` exist (or timeout, or a
        wake_all(); then []). One condition-variable park per idle
        follower — a thousand SSE clients cost no polling. A wake with
        nothing new returns [] early so the caller re-checks its own exit
        condition (the SSE generator re-reads the server's drain flag)."""
        with self._cond:
            if self._seq <= seq and timeout > 0:
                self._cond.wait(timeout)
            return self._newer_than(seq)

    def wake_all(self) -> None:
        """Wake every parked wait_since() (server drain: followers must
        notice their severed sockets NOW, not at the next heartbeat)."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        with self._lock:
            if self._w is not None:
                self._w.close()
                self._w = None
