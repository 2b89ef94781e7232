"""Size-bounded jsonl append writer (events.jsonl / traces.jsonl).

The port's copy of the JAX control plane's obs/rotate.py, unchanged.

Before this, events.jsonl grew forever — a long-lived daemon eventually
fills its state volume with telemetry, which is exactly the kind of
self-inflicted outage an observability layer must not cause. Policy:
one current file plus one rotated predecessor (`<path>.1`), so offline
analysis always has between max_mb and 2*max_mb of recent history and
disk usage is bounded by construction. The cap rides TDAPI_EVENTS_MAX_MB
(shared by both logs; 0 disables rotation).

Not thread-safe by itself: each writer is owned by exactly one logging
object (EventLog / TraceCollector) and called under that owner's lock.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger(__name__)

MAX_MB_ENV = "TDAPI_EVENTS_MAX_MB"
DEFAULT_MAX_MB = 64.0


def max_bytes_from_env() -> int:
    """The rotation threshold in bytes (0 = rotation disabled)."""
    try:
        mb = float(os.environ.get(MAX_MB_ENV, "") or DEFAULT_MAX_MB)
    except ValueError:
        mb = DEFAULT_MAX_MB
    return max(0, int(mb * 1024 * 1024))


class RotatingWriter:
    """Append text lines to `path`; when the file would cross `max_bytes`,
    atomically shunt it to `<path>.1` (replacing any previous rotation)
    and start fresh. Flushing stays the owner's policy — this class never
    flushes on its own except around a rotation (the outgoing handle is
    closed, which flushes it)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = (max_bytes_from_env() if max_bytes is None
                          else max(0, int(max_bytes)))
        self.rotations = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    def write(self, line: str) -> None:
        if self._f is None:
            return
        # size accounting in encoded BYTES, not characters — both current
        # callers json.dumps with ensure_ascii so the two agree today, but
        # the cap is a disk contract and must hold for any future caller
        n = len(line.encode("utf-8"))
        if self.max_bytes and self._size + n > self.max_bytes \
                and self._size > 0:
            self._rotate()
            if self._f is None:   # rotation lost the handle (disk gone)
                return
        self._f.write(line)
        self._size += n

    def _rotate(self) -> None:
        """Swap the full file to `<path>.1` and reopen fresh. Best-effort:
        a rotation failure (exotic filesystems without rename, disk-full)
        degrades to appending in place rather than losing the handle."""
        try:
            self._f.close()
            os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "a", encoding="utf-8")
            self._size = 0
            self.rotations += 1
        except OSError:
            # one-shot degradation: disable further rotation attempts, or
            # every subsequent telemetry line would retry the rename and
            # log a fresh traceback — a log-spam amplifier exactly during
            # the disk outage that caused the failure
            self.max_bytes = 0
            log.exception("rotating %s failed; rotation disabled, "
                          "appending in place", self.path)
            try:
                self._f = open(self.path, "a", encoding="utf-8")
            except OSError:
                self._f = None    # telemetry file lost; memory ring lives on
                log.exception("reopening %s after failed rotation", self.path)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
