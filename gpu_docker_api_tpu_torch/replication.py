"""Warm-standby replication: tail a peer daemon's watch stream into a
local replica store.

The port's copy of the JAX control plane's replication.py.

The fleet (federation.py) heals *ownership* when a daemon dies, but the
dead daemon's records lived in exactly one MVCC store on exactly one
disk. The StandbyReplicator closes that gap without a consensus
protocol: it rides the gap-free `GET /api/v1/watch` plane (every
revision, in order, FW1-proven) and applies each event to a local
replica store at the peer's EXACT revisions (put_at/delete_at), so the
replica is a prefix of the peer's history — never a reordering, never
an invention. The replicated horizon (highest contiguously applied peer
revision) is the promise promote-on-loss keeps: no revision acknowledged
at-or-below it is ever lost (tdcheck promote model, R1).

Recovery ladder, cheapest first:
- stream hiccup / peer restart → reconnect and resume from the horizon
  (watch fromRevision is exclusive, so nothing repeats, nothing skips);
- `WatchCompacted` (the peer evicted past our resume point) → full
  resync: one atomic all-resources list snapshot (list_snapshot(""))
  rebuilds the replica — stale keys tombstoned, every item re-pinned at
  its exact modRevision with exact lifetime counters — then the tail
  resumes from the snapshot revision;
- replicator crash → put_at/delete_at idempotency makes replay harmless:
  re-applying below the replica's head is a no-op, so the horizon
  sidecar may lag the store with no correctness cost.

Every `TDAPI_SNAPSHOT_EVERY` applied revisions the replica checkpoints:
maintain() bounds its WAL and the horizon sidecar is persisted (only
AFTER the store itself is durable — crashpoint repl.after_snapshot pins
the window between the two). Lag is published as tdapi_repl_* metrics
and surfaces in /healthz.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from . import faults
from .client import ApiClient, RelistRequiredError
from .federation import FLEET_PREFIX
from .store import open_store
from .store.client import ResourcePrefix

log = logging.getLogger(__name__)

#: applied-revision interval between replica checkpoints (maintain +
#: horizon persist); the env knob TDAPI_SNAPSHOT_EVERY overrides
DEFAULT_SNAPSHOT_EVERY = 512

#: reconnect backoff bounds (seconds) for the replication thread
BACKOFF_MIN = 0.2
BACKOFF_MAX = 5.0


def resource_key(resource: str, name: str) -> str:
    """The store key behind one watch identity — the inverse of
    federation.parse_watch_key."""
    if resource.startswith("fleet."):
        return f"{FLEET_PREFIX}/{resource[len('fleet.'):]}/{name}"
    return f"{ResourcePrefix.Base}/{resource}/{name}"


class StandbyReplicator:
    """Tails one peer daemon's watch stream into a local replica store.

    `peer` is "host:port". The replica lives under `replica_dir`
    (wal: replica.wal, horizon sidecar: horizon.json). Thread-safe:
    start()/stop() run the tail on a daemon thread; describe() and the
    promote-side readers (get_record/range_records) can run concurrently.
    """

    def __init__(self, peer: str, replica_dir: str, api_key: str = "",
                 engine: str = "auto",
                 snapshot_every: Optional[int] = None,
                 events=None):
        host, _, port = peer.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"peer must be host:port, got {peer!r}")
        self.peer = peer
        self._host, self._port = host, int(port)
        self._api_key = api_key
        self.events = events
        if snapshot_every is None:
            snapshot_every = int(os.environ.get("TDAPI_SNAPSHOT_EVERY", 0)
                                 or DEFAULT_SNAPSHOT_EVERY)
        self.snapshot_every = max(1, int(snapshot_every))
        os.makedirs(replica_dir, exist_ok=True)
        self._horizon_path = os.path.join(replica_dir, "horizon.json")
        self.store = open_store(
            wal_path=os.path.join(replica_dir, "replica.wal"), engine=engine)
        # the replica store IS the horizon authority (its WAL replays to
        # the last durably applied peer revision); the sidecar is the
        # cheap cross-check and the human-readable artifact
        self.horizon = max(self.store.revision, self._read_sidecar())
        self._applied_since_ckpt = 0
        self.events_applied_total = 0
        self.resyncs_total = 0
        self.connected = False
        self.peer_head = self.horizon  # highest peer revision observed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- persistence ----

    def _read_sidecar(self) -> int:
        try:
            with open(self._horizon_path, "r", encoding="utf-8") as f:
                return int(json.load(f).get("horizon", 0))
        except (OSError, ValueError):
            return 0

    def _persist_horizon(self) -> None:
        tmp = self._horizon_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"horizon": self.horizon, "peer": self.peer}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._horizon_path)

    # ---- protocol steps (thread-free; tests drive these directly) ----

    def _client(self) -> ApiClient:
        return ApiClient(self._host, self._port, spec={"paths": {}},
                         api_key=self._api_key, idempotency=False)

    def apply_event(self, ev: dict) -> bool:
        """Apply one watch event at its exact peer revision. Returns
        whether the store changed (False = idempotent replay)."""
        rev = int(ev["revision"])
        key = resource_key(ev["resource"], ev["name"])
        if ev.get("type") == "delete":
            changed = self.store.delete_at(key, rev)
        else:
            changed = self.store.put_at(key, ev.get("value") or "", rev)
        self.horizon = max(self.horizon, rev)
        self.peer_head = max(self.peer_head, rev)
        self.events_applied_total += 1
        self._applied_since_ckpt += 1
        if self._applied_since_ckpt >= self.snapshot_every:
            self.checkpoint()
        return changed

    def checkpoint(self) -> None:
        """Bound the replica WAL and persist the horizon sidecar — in
        that order: the sidecar must never claim a horizon the store
        hasn't durably applied (put_at idempotency forgives the reverse
        lag)."""
        self._applied_since_ckpt = 0
        try:
            self.store.maintain()
        except OSError:
            log.exception("replica maintain failed (disk?)")
        self._persist_horizon()
        faults.crashpoint("repl.after_snapshot")

    def resync(self) -> int:
        """Full rebuild from one atomic all-resources snapshot — the
        WatchCompacted answer. Stale replica keys (deleted on the peer
        while we were gapped) are tombstoned at the snapshot revision;
        every item is re-pinned at its exact modRevision with exact
        lifetime counters. Returns the snapshot revision (the new
        resume point)."""
        rev, items = self._client().list_resource("")
        present = set()
        for it in items:
            key = resource_key(it["resource"], it["name"])
            present.add(key)
            self.store.put_at(key, it.get("value") or "",
                              int(it["modRevision"]),
                              create_revision=it.get("createRevision"),
                              version=it.get("version"))
        for kv in list(self.store.range("")):
            if kv.key not in present:
                self.store.delete_at(kv.key, rev)
        self.horizon = max(self.horizon, rev)
        self.peer_head = max(self.peer_head, rev)
        self.resyncs_total += 1
        if self.events is not None:
            self.events.record("repl.resync", target=self.peer,
                               detail={"revision": rev,
                                       "items": len(items)})
        self.checkpoint()
        return rev

    def run_once(self) -> None:
        """One tail attempt: stream from the horizon until the
        connection breaks (return: caller reconnects) or the peer
        demands a relist (resync, then return)."""
        client = self._client()
        try:
            self.connected = True
            for ev in client.watch(from_revision=self.horizon,
                                   heartbeat=5.0):
                self.apply_event(ev)
                if self._stop.is_set():
                    return
        except RelistRequiredError:
            self.resync()
        finally:
            self.connected = False
            client.close()

    # ---- daemon thread ----

    def start(self) -> None:
        self._stop.clear()

        def loop():
            backoff = BACKOFF_MIN
            while not self._stop.is_set():
                try:
                    self.run_once()
                    backoff = BACKOFF_MIN   # clean return: stream ended
                except Exception:  # noqa: BLE001 — keep replicating
                    log.debug("replication tail broke (peer %s); "
                              "retrying in %.1fs", self.peer, backoff,
                              exc_info=True)
                    backoff = min(BACKOFF_MAX, backoff * 2)
                self._stop.wait(backoff)

        self._thread = threading.Thread(target=loop, name="repl-standby",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.checkpoint()
        self.store.close()

    # ---- promote-side readers (App._fleet_promote) ----

    def get_record(self, resource: str, name: str):
        """The replica's copy of one record (KeyValue or None)."""
        return self.store.get(resource_key(resource, name))

    def describe(self) -> dict:
        """The /healthz replication block."""
        return {
            "peer": self.peer,
            "horizon": self.horizon,
            "peerHead": self.peer_head,
            "lagRevisions": max(0, self.peer_head - self.horizon),
            "eventsApplied": self.events_applied_total,
            "resyncs": self.resyncs_total,
            "connected": self.connected,
        }
