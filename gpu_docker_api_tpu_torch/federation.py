"""Federation's watch half: list+watch on MVCC revisions.

The port's copy of the JAX control plane's federation.py, the watch half
only (`parse_watch_key`, `WatchCompactedError`, `WatchHub`,
`WatchedStore`): every store mutation enters a bounded ring in exactly
revision order (the hub is fed under the write serialization lock,
engine-agnostically); `GET /api/v1/watch` resumes from any retained
revision, and a resume below the retention floor is REFUSED (`revision
too old`) so the client relists instead of silently skipping. W1: zero
dropped, zero duplicated revisions.

The fleet half (HashRing, the lease arbiter, members and takeover) is
not ported yet; the key layout of its plane (FLEET_PREFIX) is kept so a
store written by a JAX fleet member parses the same here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .store.client import ResourcePrefix

FLEET_PREFIX = "/tpu-docker-api/fleet"


def parse_watch_key(key: str) -> Optional[tuple[str, str]]:
    """Map a store key to its (resource, name) watch identity, or None
    for keys the watch plane does not expose (version history, scheduler
    bitmaps live one level deeper and are implementation detail)."""
    if key.startswith(FLEET_PREFIX + "/"):
        rest = key[len(FLEET_PREFIX) + 1:]
        kind, _, name = rest.partition("/")
        if kind and name:
            return (f"fleet.{kind}", name)
        return None
    base = ResourcePrefix.Base + "/"
    if key.startswith(base):
        parts = key[len(base):].split("/")
        if len(parts) == 2 and parts[0] and parts[1]:
            return (parts[0], parts[1])
    return None


# --------------------------------------------------------------- watch hub


class WatchCompactedError(Exception):
    """Resume revision is below the hub's retention floor: the events in
    between were evicted (or predate this daemon's boot) — the watcher
    must relist and restart from the snapshot's revision."""

    def __init__(self, from_revision: int, floor: int):
        super().__init__(
            f"revision too old: fromRevision {from_revision} < retention "
            f"floor {floor} — relist required")
        self.from_revision = from_revision
        self.floor = floor


class WatchHub:
    """Bounded ring of watch events keyed by MVCC revision.

    Fed by `WatchedStore` in exactly commit order; `events_since(R)`
    returns every retained event with revision > R. Completeness
    contract: the result is the COMPLETE set of watchable changes after
    R iff R >= floor; below the floor the call raises
    WatchCompactedError instead of serving a silent gap. The floor
    starts at the store revision the hub was attached at (history before
    boot lives in the store, not the ring) and rises as the ring evicts.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = max(16, int(capacity))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._ring: deque = deque()
        self.floor = 0              # revisions <= floor may be incomplete
        self.head = 0               # highest revision noted
        self.events_total = 0

    def attach(self, revision: int) -> None:
        """Anchor the retention floor at the store's current revision."""
        with self._lock:
            self.floor = max(self.floor, revision)
            self.head = max(self.head, revision)

    def note(self, revision: int, key: str, value: Optional[str],
             deleted: bool) -> None:
        """Called by WatchedStore under its write lock — strictly
        ascending revisions by construction."""
        ident = parse_watch_key(key)
        with self._cond:
            self.head = max(self.head, revision)
            if ident is None:
                return
            if len(self._ring) >= self.capacity:
                self.floor = self._ring.popleft()["revision"]
            self._ring.append({
                "revision": revision,
                "resource": ident[0],
                "name": ident[1],
                "type": "delete" if deleted else "put",
                "value": value,
            })
            self.events_total += 1
            self._cond.notify_all()

    def events_since(self, revision: int,
                     resource: str = "") -> list[dict]:
        with self._lock:
            return self._since_locked(revision, resource)

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _since_locked(self, revision: int, resource: str) -> list[dict]:
        if revision < self.floor:
            raise WatchCompactedError(revision, self.floor)
        return [e for e in self._ring
                if e["revision"] > revision
                and (not resource or e["resource"] == resource)]

    def wait_since(self, revision: int, resource: str = "",
                   timeout: float = 1.0) -> list[dict]:
        """Blocking flavour for the SSE stream thread: returns as soon as
        a matching event lands, or [] on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                out = self._since_locked(revision, resource)
                if out:
                    return out
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._cond.wait(left)

    def wake_all(self) -> None:
        with self._cond:
            self._cond.notify_all()


class WatchedStore:
    """Engine-agnostic watch seam over any MVCC store.

    put/put_many/delete run under one feed lock so watch events enter
    the hub in exactly revision order — the only way "resume from
    revision R" can be exact without cooperation from the engine (the
    native core has no observer hook). The second serialization is paid
    deliberately: the python engine already serializes writers under its
    own lock, and at control-plane mutation rates the native engine's
    loss is noise (the data plane never writes here). Reads pass through
    untouched; unknown attributes forward to the wrapped store, so the
    wrapper is drop-in for StateClient, maintenance, and tests.
    """

    def __init__(self, inner, hub: WatchHub):
        self._inner = inner
        self._hub = hub
        self._wlock = threading.Lock()
        hub.attach(inner.revision)

    # ---- write path (serialized; feeds the hub in commit order) ----

    def put(self, key: str, value: str) -> int:
        with self._wlock:
            rev = self._inner.put(key, value)
            self._hub.note(rev, key, value, deleted=False)
        return rev

    def put_many(self, items) -> int:
        items = list(items)
        with self._wlock:
            rev = self._inner.put_many(items)
            # put_many mints one revision per item, ending at `rev`
            first = rev - len(items) + 1
            for i, (key, value) in enumerate(items):
                self._hub.note(first + i, key, value, deleted=False)
        return rev

    def delete(self, key: str) -> bool:
        with self._wlock:
            existed = self._inner.delete(key)
            if existed:
                # writers are serialized HERE, so the store's current
                # revision is exactly the tombstone this delete minted
                self._hub.note(self._inner.revision, key, None,
                               deleted=True)
        return existed

    # ---- snapshot for list+watch ----

    def list_snapshot(self, resource: str) -> tuple[int, list[dict]]:
        """Atomic (revision, items) pair: the revision is a valid watch
        resume point for exactly this item set (writers can't interleave
        — they need the feed lock).

        resource "" lists EVERY watch-visible key (all resources plus the
        fleet.* planes) — the full-resync snapshot a StandbyReplicator
        rebuilds its replica from after a WatchCompacted gap. Those items
        additionally carry resource / createRevision / version so the
        replica reconstructs exact lifetime counters."""
        if resource == "":
            with self._wlock:
                rev = self._inner.revision
                kvs = list(self._inner.range(ResourcePrefix.Base + "/"))
                kvs += list(self._inner.range(FLEET_PREFIX + "/"))
            items = []
            for kv in kvs:
                ident = parse_watch_key(kv.key)
                if ident is None:
                    continue
                items.append({"resource": ident[0], "name": ident[1],
                              "value": kv.value,
                              "modRevision": kv.mod_revision,
                              "createRevision": kv.create_revision,
                              "version": kv.version})
            return rev, items
        if resource.startswith("fleet."):
            prefix = f"{FLEET_PREFIX}/{resource[len('fleet.'):]}/"
        else:
            prefix = f"{ResourcePrefix.Base}/{resource}/"
        with self._wlock:
            rev = self._inner.revision
            kvs = self._inner.range(prefix)
        items = [{"name": kv.key[len(prefix):], "value": kv.value,
                  "modRevision": kv.mod_revision} for kv in kvs]
        return rev, items

    # ---- passthrough ----

    @property
    def revision(self) -> int:
        return self._inner.revision

    def __getattr__(self, name):
        return getattr(self._inner, name)
