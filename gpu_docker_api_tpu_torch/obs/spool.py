"""Worker span spooling: per-process span files, merged by the daemon.

The port's copy of the JAX control plane's obs/spool.py, unchanged.

Worker processes (server/workers.py) mint real spans — an ingress root
honoring the client's `traceparent`, admit/forward children with the
replica's advertised queue-wait stitched in — but they must not share
the daemon's TraceCollector (its ring and jsonl writer are one-process
objects). Instead each worker spools finished spans to its own
``spans-<pid>.jsonl`` (size-rotated, obs/rotate.py) and the daemon's
worker-tier watchdog TAILS those files, merging rows into the one
TraceCollector that serves ``GET /api/v1/traces`` — so a data-plane
request's trace assembles the full client -> worker admit/route ->
replica chain next to every control-plane trace, with the same
keep-slowest retention.

The wire row is a span's ``to_json()`` plus ``"root": true`` on trace
roots (the merge finalizes the trace on those, exactly as a local root
finish would).

**Tail sampling.** Spooling every data-plane request's span tree costs
one json+write per span in the worker AND one parse+merge in the daemon
— measured ~25% of worker-tier throughput on a small box, against the
obs criterion of <= 5%. So the spool decides per TRACE, when its root
finishes (children buffer in memory until then), and keeps exactly the
traces an operator ever looks up:

- the client sent a ``traceparent`` (an explicitly-traced request —
  the cross-process acceptance path is always complete);
- the request FAILED (root outcome != ok);
- the request was SLOW (root duration >= ``slow_ms``, default 250ms —
  the keep-slowest retention's admission twin);
- a 1-in-``sample_n`` uniform sample (default 64) so the steady-state
  shape stays observable.

Everything else is dropped before any I/O happens; the metric shards
(obs/shm_metrics.py) still count every request.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time

from .rotate import RotatingWriter

log = logging.getLogger(__name__)

SPOOL_GLOB = "spans-*.jsonl"


class SpanSpool:
    """Worker-side span sink, duck-typed as a trace collector: obs/trace
    spans call ``record_span`` on whatever collector their root carried,
    so handing a SpanSpool to the worker's ApiServer (``traces=``) routes
    the whole request tree here with zero changes to the span machinery."""

    #: flush cadence — a spooled root flushes at most this often, so the
    #: daemon tailer (50ms poll) sees complete requests promptly without
    #: paying an fflush per span
    FLUSH_INTERVAL_S = 0.1
    #: tail-sampling defaults (see module doc); env-overridable
    SLOW_MS_ENV = "TDAPI_SPOOL_SLOW_MS"
    SAMPLE_ENV = "TDAPI_SPOOL_SAMPLE"
    DEFAULT_SLOW_MS = 250.0
    DEFAULT_SAMPLE_N = 64
    #: in-flight trace buffer bound: a trace whose root never finishes
    #: (killed handler thread) must not grow the dict forever
    MAX_PENDING = 512

    def __init__(self, path: str, recorder=None,
                 slow_ms: "float | None" = None,
                 sample_n: "int | None" = None):
        self._lock = threading.Lock()
        self._w = RotatingWriter(path)
        self._last_flush = 0.0
        self._pending: dict[str, list] = {}
        self._roots_seen = 0
        self.spans_total = 0
        self.traces_spooled = 0
        self.traces_dropped = 0
        #: optional FlightRecorder: spooled roots leave a ring entry, so
        #: the recorder's final segment shows what the worker was serving
        self.recorder = recorder

        def _env(name, cast, default):
            try:
                return cast(os.environ.get(name, "") or default)
            except ValueError:
                return default

        self.slow_ms = (float(slow_ms) if slow_ms is not None
                        else _env(self.SLOW_MS_ENV, float,
                                  self.DEFAULT_SLOW_MS))
        self.sample_n = (int(sample_n) if sample_n is not None
                         else _env(self.SAMPLE_ENV, int,
                                   self.DEFAULT_SAMPLE_N))

    def _keep(self, span) -> bool:
        """The tail-sampling decision, taken at root finish (module
        doc): client-traced, failed, slow, or the uniform sample."""
        if span.parent_id is not None:       # inbound traceparent
            return True
        if span.outcome != "ok":
            return True
        if span.duration_ms >= self.slow_ms:
            return True
        return bool(self.sample_n) and \
            self._roots_seen % self.sample_n == 0

    def record_span(self, span) -> None:
        keep_root = None
        with self._lock:
            self.spans_total += 1
            if not span._root:
                # child: buffer the finished Span OBJECT until the
                # trace's root decides; serialization (to_json + dumps)
                # is deferred past the sampling gate, so a dropped trace
                # costs a list append, not I/O
                spans = self._pending.get(span.trace_id)
                if spans is None:
                    if len(self._pending) >= self.MAX_PENDING:
                        self._pending.pop(next(iter(self._pending)))
                    spans = self._pending[span.trace_id] = []
                spans.append(span)
                return
            spans = self._pending.pop(span.trace_id, [])
            self._roots_seen += 1
            keep_root = self._keep(span)
            if not keep_root:
                self.traces_dropped += 1
            else:
                self.traces_spooled += 1
                row = span.to_json()
                row["root"] = True
                for s in spans:
                    self._w.write(json.dumps(
                        s.to_json(), separators=(",", ":")) + "\n")
                self._w.write(json.dumps(
                    row, separators=(",", ":")) + "\n")
                now = time.monotonic()
                if now - self._last_flush >= self.FLUSH_INTERVAL_S:
                    self._w.flush()
                    self._last_flush = now
        if keep_root and self.recorder is not None:
            self.recorder.note("span", op=span.op, target=span.target,
                               traceId=span.trace_id,
                               ms=round(span.duration_ms, 1),
                               status=span.outcome)

    def close(self) -> None:
        with self._lock:
            self._w.flush()
            self._w.close()


class SpoolTailer:
    """Daemon-side merger: tail every ``spans-*.jsonl`` under `spool_dir`
    into `traces` (a TraceCollector). Tracks a byte offset per file;
    a file that shrank (RotatingWriter rotation) restarts from zero —
    the rotated-away tail was already read on a previous poll (polls run
    every watchdog tick, far faster than a spool fills)."""

    def __init__(self, spool_dir: str, traces):
        self.spool_dir = spool_dir
        self.traces = traces
        self._offsets: dict[str, int] = {}
        self._partial: dict[str, bytes] = {}

    def forget(self, path: str) -> None:
        """Drop a pruned file's tail state (WorkerTier removes a dead
        worker's spool after the reap's final merge)."""
        self._offsets.pop(path, None)
        self._partial.pop(path, None)

    def poll(self) -> int:
        """Merge newly-spooled rows; returns how many spans landed."""
        merged = 0
        try:
            paths = glob.glob(os.path.join(self.spool_dir, SPOOL_GLOB))
        except OSError:
            return 0
        for path in sorted(paths):
            merged += self._poll_file(path)
        return merged

    def _poll_file(self, path: str) -> int:
        off = self._offsets.get(path, 0)
        try:
            size = os.path.getsize(path)
            if size < off:                     # rotated under us
                off = 0
                self._partial.pop(path, None)
            if size == off:
                return 0
            with open(path, "rb") as f:
                f.seek(off)
                chunk = f.read()
        except OSError:
            return 0
        self._offsets[path] = off + len(chunk)
        data = self._partial.pop(path, b"") + chunk
        lines = data.split(b"\n")
        if lines and lines[-1]:                # unterminated tail: keep it
            self._partial[path] = lines[-1]
        merged = 0
        for line in lines[:-1]:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue                       # torn line (worker died mid-write)
            if not isinstance(row, dict) or "traceId" not in row:
                continue
            try:
                self.traces.ingest_row(row)
                merged += 1
            except Exception:  # noqa: BLE001 — one bad row must not stop the merge
                log.exception("span spool merge: bad row in %s", path)
        return merged
