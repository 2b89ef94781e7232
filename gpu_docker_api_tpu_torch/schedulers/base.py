"""Scheduler contract.

The reference documents this shape but never actually uses it as an
interface — its Apply return types diverge (internal/schedulers/
scheduler.go:3-9, SURVEY §2). Here it is a real ABC: every scheduler
serializes itself, persists asynchronously under ITS OWN store key (the
reference's port scheduler accidentally persisted the GPU map under the gpus
key — portscheduler.go:163-169, SURVEY §2 bug 1), and restores from the
store at boot.
"""

from __future__ import annotations

import abc
import json
import threading
from typing import Optional

from ..store.client import StateClient
from ..workqueue import PutKeyValue, WorkQueue

# Status maps are {index: owner}: None = free, "" = anonymous grant, any
# other string = the replicaSet that holds the resource. Ownership makes
# restore() safe against double-frees ACROSS owners: you can only free what
# you hold (the reference's byte-map can't tell whose resource it frees —
# the root of SURVEY §2 bug 3's whole class).
FREE = None


def _norm_owner(v) -> Optional[str]:
    """Normalize a stored status value: legacy ints (0 free / 1 used) from
    the byte-map format, or owner strings."""
    if v in (0, None):
        return None
    if v == 1:
        return ""
    return str(v)


def merge_stored_status(stored: Optional[dict],
                        fresh: dict[int, Optional[str]]) -> dict[int, Optional[str]]:
    """Overlay a stored {index: owner} map onto a freshly-probed one, keeping
    only indices that still exist on this host (shared by the TPU and CPU
    scheduler boot paths)."""
    if stored:
        for k, v in stored.items():
            ik = int(k)
            if ik in fresh:
                fresh[ik] = _norm_owner(v)
    return fresh


class Scheduler(abc.ABC):
    """Common machinery: lock, store-backed boot, async persist."""

    #: resource segment in the store key space — unique per scheduler
    resource: str = ""
    #: key under that segment holding the serialized state
    state_key: str = ""

    def __init__(self, client: Optional[StateClient] = None,
                 wq: Optional[WorkQueue] = None):
        self._client = client
        self._wq = wq
        self._lock = threading.RLock()

    # ---- persistence ----

    def _load_state(self) -> Optional[dict]:
        if self._client is None:
            return None
        kv = self._client.get(self.resource, self.state_key)
        if kv is None:
            return None
        try:
            return json.loads(kv.value)
        except json.JSONDecodeError:
            return None

    def _persist(self) -> None:
        """Queue a write of the current serialized state. Called with the
        scheduler lock held so snapshot order == persist order. The snapshot
        (serialize() — fresh dicts of immutable values) is taken under the
        lock, but the json.dumps runs on the workqueue DRAINER via a
        deferred payload: the grant path never pays serialization, and a
        burst of grants coalesces to one store write of the newest
        snapshot."""
        if self._client is None:
            return
        snap = self.serialize()
        if self._wq is not None:
            self._wq.submit(PutKeyValue(
                self.resource, self.state_key,
                lambda: json.dumps(snap, sort_keys=True)))
        else:
            self._client.put(self.resource, self.state_key,
                             json.dumps(snap, sort_keys=True))

    # tdlint: disable=io-under-lock -- deliberate: the shutdown flush must
    # write under the lock, or a concurrent mutation's persist could be
    # overwritten by this (then-stale) snapshot
    def flush(self) -> None:
        """Synchronous persist for graceful shutdown (reference Stop flush,
        cmd/gpu-docker-api/main.go:139-154). The put happens under the lock —
        releasing first would let a concurrent mutation's persist be
        overwritten by this (then-stale) snapshot."""
        if self._client is None:
            return
        with self._lock:
            self._client.put(self.resource, self.state_key,
                             json.dumps(self.serialize(), sort_keys=True))

    # ---- cross-thread read surface ----

    def owners(self) -> dict:
        """Locked snapshot of the ownership map ({index: owner}). This is
        the only sanctioned way for ANOTHER object (reconciler, health
        monitor, route handlers) to read a scheduler's state: iterating the
        live dict races its writers — a concurrent grant mutates it
        mid-iteration (RuntimeError) or yields a torn multi-key view.
        Enforced by tdlint's unlocked-state rule."""
        with self._lock:
            return dict(self.status)

    # ---- contract ----

    @abc.abstractmethod
    def serialize(self) -> dict:
        """JSON-able state snapshot."""

    @abc.abstractmethod
    def apply(self, n: int):
        """Grant n resources; raises *NotEnoughError on shortage."""

    @abc.abstractmethod
    def restore(self, grant) -> None:
        """Return a grant to the pool."""
