"""Per-process flight recorder: a cheap always-on ring of recent events.

A postmortem is only as good as what the dead process left behind. The
event log and trace ring live in the DAEMON; a worker process that takes
a SIGKILL mid-request leaves nothing but a respawn line. The flight
recorder closes that gap: every process keeps a small bounded ring of
its most recent telemetry moments (request arrivals, sheds, retries,
finished root spans, lifecycle marks) that costs one dict + deque append
per note, and flushes it:

- on graceful exit — ``flush_to()`` writes ``recorder-<pid>.json`` from
  the SIGTERM/atexit path (workers: the drain finally; daemon:
  ``App.stop()``, which the cli's SIGTERM handler drives);
- continuously into SHARED MEMORY when a ``sink`` is installed (workers
  mirror each note into their shm recorder ring —
  obs/shm_metrics.py ``ring_writer``), which is what makes the ring
  readable by the daemon's watchdog even after a SIGKILL, where no
  handler ever ran. That read is the "final recorder segment" in the
  ``gateway.worker_postmortem`` bundle.

The recorder is telemetry, not a ledger: a torn shm slot or a lost
buffered tail is acceptable by contract; the in-memory ring is always
whole for the process that owns it.

The port's copy of the JAX control plane's obs/recorder.py, unchanged:
the daemon records into the in-process ring and flushes on graceful
stop; each data-plane worker (server/workers.py) into its shm ring.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Optional


class FlightRecorder:
    """Bounded ring of recent telemetry entries for ONE process."""

    def __init__(self, capacity: int = 256,
                 sink: Optional[Callable[[dict], None]] = None):
        self.capacity = max(16, int(capacity))
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._sink = sink
        self.notes_total = 0

    def note(self, kind: str, **data) -> None:
        """Append one entry. Hot-path cheap: a dict, a deque append, and
        (workers) one shm ring write; never raises."""
        entry = {"t": round(time.time(), 3), "k": kind}
        if data:
            entry.update(data)
        with self._lock:
            self._ring.append(entry)
            self.notes_total += 1
        sink = self._sink
        if sink is not None:
            try:
                sink(entry)
            # tdlint: disable=silent-swallow -- a dead shm segment must not fail the request that noted; the in-memory ring kept the entry
            except Exception:  # noqa: BLE001
                pass

    def note_event(self, evt: dict) -> None:
        """EventLog mirror hook (daemon side): fold a recorded event row
        into the ring as a compact entry."""
        self.note("event", op=evt.get("op", ""),
                  target=evt.get("target", ""), code=evt.get("code", 0))

    def dump(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def flush_to(self, path: str) -> bool:
        """Write the ring to `path` (the graceful-exit postmortem file).
        Best-effort: the process is dying, a failed write changes
        nothing."""
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"pid": os.getpid(),
                           "flushedAt": round(time.time(), 3),
                           "notesTotal": self.notes_total,
                           "entries": self.dump()}, f)
            return True
        except OSError:
            return False
