"""Federation: N daemons, one fleet.

The port's copy of the JAX control plane's federation.py, both halves.
The reference control plane gets multi-daemon coordination from its
external etcd; this tree embeds its store, so the coordination plane is
built here on the same MVCC revision machinery: one daemon HOSTS the fleet
state in its store (the single point, where the reference's etcd endpoint
sits), and every daemon (the host included) runs a `FleetMember` against
it.

Three protocols live in this module, each model-checked by tdcheck
(tools/tdcheck/models.py's `lease` and `fedwatch` models drive these
classes through a cooperative scheduler with SIGKILLs at every yield
point; tests/test_torch_tdcheck.py sweeps them over this module):

* **TTL leases + grants** (`FleetArbiter`): a member holds a lease
  (heartbeat-renewed, arbitrated on the ARBITER's clock alone: the
  members' clocks are never compared) and acquires per-resource grants.
  The consistent-hash ring (`HashRing`) decides which live member may
  acquire a name; a grant whose holder's lease expired is stealable by
  the current ring owner, and that steal is the takeover. L1: at most one
  live-leased owner per resource at every observable store state.
* **Takeover** (`FleetMember`): on every heartbeat the member sweeps the
  grant table for orphans it now owns, steals them, and re-derives the
  adopted state through its adopt callback (the boot reconciler's
  derive-don't-store idiom: no roster is persisted that a crash could
  corrupt; the grant table and the substrate are the only truth). L2:
  after a member SIGKILL, ownership re-converges onto live members within
  one lease TTL and one heartbeat.
* **List+watch on MVCC revisions** (`WatchedStore` + `WatchHub`): every
  store mutation enters a bounded ring in exactly revision order (the
  hub is fed under the write serialization lock, engine-agnostically);
  `GET /api/v1/watch` resumes from any retained revision, and a resume
  below the retention floor is REFUSED (`revision too old`) so the
  client relists instead of silently skipping. W1: zero dropped, zero
  duplicated revisions across a takeover.

Fencing: every arbiter verb requires a live lease. A member whose lease
expired under it (stalled process, partition) learns on its next call,
`LeaseError("no-lease")`, and drops its believed ownership before
rejoining; `FleetMember` does exactly that.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

from .faults import crashpoint, fault_gate
from .store.client import ResourcePrefix

log = logging.getLogger(__name__)

FLEET_PREFIX = "/tpu-docker-api/fleet"
LEASE_PREFIX = f"{FLEET_PREFIX}/leases"
GRANT_PREFIX = f"{FLEET_PREFIX}/grants"

#: default lease TTL (seconds); heartbeat runs at TTL/3 so two beats can
#: be lost before expiry
DEFAULT_TTL = 5.0

#: virtual nodes per member on the hash ring — enough to spread a
#: handful of daemons evenly without making owner_of() a hot loop
VNODES = 32


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


# ---------------------------------------------------------------- leases


class LeaseError(Exception):
    """Typed arbiter refusal. `reason` is one of:
    - "no-lease": caller has no live lease (expired or never joined) —
      FENCE: drop believed ownership, rejoin, reacquire through the ring
    - "not-owner": the hash ring assigns this name to another live member
    - "held": the grant is held by another LIVE member (steal refused)
    """

    def __init__(self, reason: str, message: str, owner: str = ""):
        super().__init__(message)
        self.reason = reason
        self.owner = owner


class HashRing:
    """Deterministic consistent hash over the live membership: every
    daemon computes the same owner for a name from the same member list,
    with no negotiation. sha256 so the placement is stable across
    processes and python versions (hash() is salted)."""

    @staticmethod
    def _h(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big")

    @classmethod
    def owner_of(cls, key: str, members) -> Optional[str]:
        members = sorted(set(members))
        if not members:
            return None
        ring = sorted((cls._h(f"{m}#{i}"), m)
                      for m in members for i in range(VNODES))
        kh = cls._h(key)
        for vh, m in ring:
            if vh >= kh:
                return m
        return ring[0][1]


def grant_key(resource: str, name: str) -> str:
    return f"{GRANT_PREFIX}/{resource}:{name}"


class FleetArbiter:
    """Server-side lease + grant arbitration, hosted by ONE daemon over
    its (watched) store. Every decision — join, renew, expiry, steal —
    runs under one lock on the ARBITER's own clock; members only ever
    say "I'm alive", never "what time is it", so cross-process clock
    skew cannot split ownership.

    Stored state is the fleet's system of record: lease docs under
    fleet/leases/, grant docs under fleet/grants/. On construction any
    lease rows left by a previous incarnation are swept — a monotonic
    clock does not survive the process, so inherited expiries are
    meaningless; members re-join within one heartbeat and re-acquire
    their grants (own-holder acquire is idempotent). Grants persist
    across the sweep: a grant whose holder never returns is exactly the
    stealable-orphan case takeover exists for.
    """

    def __init__(self, store, ttl: float = DEFAULT_TTL,
                 clock: Callable[[], float] = time.monotonic,
                 events=None):
        self.store = store
        self.ttl = float(ttl)
        self.clock = clock
        self.events = events
        self._lock = threading.RLock()
        self.renewals_total = 0
        self.steals_total = 0
        self.expiries_total = 0
        for kv in self.store.range(LEASE_PREFIX + "/"):
            self.store.delete(kv.key)   # stale clock domain — see above

    # ---- helpers (caller holds _lock) ----

    def _event(self, op: str, target: str, **detail) -> None:
        if self.events is not None:
            self.events.record(op, target=target, detail=detail or None)

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _leases(self) -> dict[str, dict]:
        return {kv.key[len(LEASE_PREFIX) + 1:]: json.loads(kv.value)
                for kv in self.store.range(LEASE_PREFIX + "/")}

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _sweep_expired(self, now: float) -> dict[str, dict]:
        """Drop expired leases (lazily, on every read of the membership)
        and return the live set."""
        live = {}
        for member, doc in self._leases().items():
            if doc["expiresAt"] > now:
                live[member] = doc
            else:
                self.store.delete(f"{LEASE_PREFIX}/{member}")
                self.expiries_total += 1
                self._event("fed.expire", member,
                            ttl=self.ttl, epoch=doc.get("epoch", 0))
        return live

    # ---- membership ----

    def join(self, member: str, addr: str = "") -> dict:
        if not member:
            raise LeaseError("no-lease", "member id must be non-empty")
        with self._lock:
            now = self.clock()
            live = self._sweep_expired(now)
            prev = live.get(member)
            doc = {"member": member, "addr": addr,
                   "expiresAt": now + self.ttl,
                   "epoch": (prev or {}).get("epoch", 0) + 1}
            self.store.put(f"{LEASE_PREFIX}/{member}", json.dumps(doc))
            live[member] = doc
            self._event("fed.join", member, epoch=doc["epoch"],
                        members=sorted(live))
            return {"member": member, "ttl": self.ttl,
                    "epoch": doc["epoch"], "members": sorted(live)}

    def renew(self, member: str) -> dict:
        with self._lock:
            now = self.clock()
            live = self._sweep_expired(now)
            doc = live.get(member)
            if doc is None:
                raise LeaseError(
                    "no-lease",
                    f"{member}: no live lease — rejoin and reacquire")
            doc["expiresAt"] = now + self.ttl
            self.store.put(f"{LEASE_PREFIX}/{member}", json.dumps(doc))
            self.renewals_total += 1
            return {"member": member, "ttl": self.ttl,
                    "epoch": doc["epoch"], "members": sorted(live)}

    def leave(self, member: str) -> dict:
        """Graceful exit: the lease goes, and so do the member's grants
        — a leaving daemon stops serving, so its slice is immediately
        adoptable instead of waiting out the TTL."""
        with self._lock:
            released = []
            for g in self.grants():
                if g["holder"] == member:
                    self.store.delete(grant_key(g["resource"], g["name"]))
                    released.append(f"{g['resource']}:{g['name']}")
            self.store.delete(f"{LEASE_PREFIX}/{member}")
            self._event("fed.leave", member, released=released)
            return {"member": member, "released": released}

    def members(self) -> list[dict]:
        with self._lock:
            now = self.clock()
            live = self._sweep_expired(now)
            return [{"member": m, "addr": doc.get("addr", ""),
                     "epoch": doc["epoch"],
                     "ttlRemaining": round(doc["expiresAt"] - now, 3)}
                    for m, doc in sorted(live.items())]

    # ---- grants ----

    def grants(self) -> list[dict]:
        with self._lock:
            out = []
            for kv in self.store.range(GRANT_PREFIX + "/"):
                doc = json.loads(kv.value)
                doc["modRevision"] = kv.mod_revision
                out.append(doc)
            return out

    def acquire(self, resource: str, name: str, member: str) -> dict:
        """Grant `resource/name` to `member`. Requires: live lease, ring
        ownership over the live membership, and the grant free / already
        the caller's / held by an EXPIRED member (that last case is the
        takeover steal). One lock, so two concurrent acquirers get one
        winner and one clean LeaseError — never two grants."""
        with self._lock:
            now = self.clock()
            live = self._sweep_expired(now)
            if member not in live:
                raise LeaseError(
                    "no-lease",
                    f"{member}: no live lease — rejoin and reacquire")
            owner = HashRing.owner_of(f"{resource}/{name}", live)
            if owner != member:
                raise LeaseError(
                    "not-owner",
                    f"{resource}/{name} hashes to {owner}, not {member}",
                    owner=owner or "")
            gk = grant_key(resource, name)
            kv = self.store.get(gk)
            prev = json.loads(kv.value) if kv is not None else None
            stolen = ""
            if prev is not None and prev["holder"] == member:
                # idempotent re-acquire: the epoch is a fencing token and
                # advances only on ownership CHANGE — rewriting the row
                # here would also spray no-op events at every watcher
                doc = dict(prev)
                doc["stolenFrom"] = ""
                return doc
            if prev is not None:
                if prev["holder"] in live:
                    raise LeaseError(
                        "held",
                        f"{resource}/{name} held by live member "
                        f"{prev['holder']}", owner=prev["holder"])
                stolen = prev["holder"]
            doc = {"resource": resource, "name": name, "holder": member,
                   "epoch": (prev or {}).get("epoch", 0) + 1}
            self.store.put(gk, json.dumps(doc))
            if stolen:
                self.steals_total += 1
                self._event("fed.steal", f"{resource}/{name}",
                            holder=member, stolenFrom=stolen,
                            epoch=doc["epoch"])
            else:
                self._event("fed.grant", f"{resource}/{name}",
                            holder=member, epoch=doc["epoch"])
            doc = dict(doc)
            doc["stolenFrom"] = stolen
            return doc

    def release(self, resource: str, name: str, member: str) -> bool:
        with self._lock:
            gk = grant_key(resource, name)
            kv = self.store.get(gk)
            if kv is None:
                return False
            if json.loads(kv.value)["holder"] != member:
                raise LeaseError(
                    "held", f"{resource}/{name} is not {member}'s to "
                    f"release", owner=json.loads(kv.value)["holder"])
            self.store.delete(gk)
            return True


# ------------------------------------------------------------ rest bridge


class RestArbiter:
    """Member-side bridge to a remote daemon's arbiter over the fleet
    REST endpoints (server/fleet.py). Same verbs as FleetArbiter, same
    LeaseError surface; every call crosses a `fed.rpc` fault gate so the
    partition fault mode can sever exactly this link."""

    def __init__(self, base_url: str, api_key: str = "",
                 timeout: float = 5.0):
        u = base_url.rstrip("/")
        u = u[len("http://"):] if u.startswith("http://") else u
        self.host, _, port = u.partition(":")
        self.port = int(port or 2378)
        self.api_key = api_key
        self.timeout = timeout

    def _call(self, method: str, path: str, body: Optional[dict] = None):
        fault_gate("fed.rpc")
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if self.api_key:
                headers["Authorization"] = f"Bearer {self.api_key}"
            conn.request(method, path,
                         json.dumps(body) if body is not None else None,
                         headers)
            out = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if out.get("code") != 200:
            reason = (out.get("data") or {}).get("reason", "no-lease")
            raise LeaseError(reason, out.get("msg", "fleet call failed"),
                             owner=(out.get("data") or {}).get("owner", ""))
        return out.get("data") or {}

    def join(self, member: str, addr: str = "") -> dict:
        return self._call("POST", "/api/v1/fleet/lease",
                          {"member": member, "addr": addr})

    def renew(self, member: str) -> dict:
        return self._call("POST", f"/api/v1/fleet/lease/{member}/renew")

    def leave(self, member: str) -> dict:
        return self._call("DELETE", f"/api/v1/fleet/lease/{member}")

    def members(self) -> list[dict]:
        return self._call("GET", "/api/v1/fleet/members")["members"]

    def grants(self) -> list[dict]:
        return self._call("GET", "/api/v1/fleet/grants")["grants"]

    def acquire(self, resource: str, name: str, member: str) -> dict:
        return self._call("POST", "/api/v1/fleet/grants",
                          {"resource": resource, "name": name,
                           "member": member})

    def release(self, resource: str, name: str, member: str) -> bool:
        return self._call("POST", "/api/v1/fleet/grants/release",
                          {"resource": resource, "name": name,
                           "member": member}).get("released", False)


# ---------------------------------------------------------------- member


class FleetMember:
    """One daemon's seat in the fleet.

    Holds the believed-owned set IN MEMORY ONLY (derive-don't-store: on
    any restart or fence it is rebuilt from the arbiter's grant table,
    never trusted from local state). `heartbeat_once` is the whole
    protocol step — renew, fence on lease loss, sweep for orphaned
    grants this member now ring-owns, steal + adopt them — and is
    exactly what the tdcheck `lease` model drives; the daemon thread
    just calls it on a TTL/3 cadence.

    `crash_seam` defaults to the production crashpoints
    (fed.after_acquire / fed.after_takeover); the model swaps in a
    scheduler yield so a SIGKILL can land in precisely those windows.
    """

    def __init__(self, member_id: str, arbiter, addr: str = "",
                 adopt: Optional[Callable[[str, str], None]] = None,
                 promote: Optional[Callable[[str, str], None]] = None,
                 events=None,
                 crash_seam: Callable[[str], None] = crashpoint):
        self.member_id = member_id
        self.arbiter = arbiter
        self.addr = addr
        self.adopt = adopt
        # promote(resource, name) runs after a takeover steal SUCCEEDS
        # and before adopt: install the dead daemon's replicated record
        # into the local store so adopt reconciles real state instead of
        # a hole (replication.py). The
        # successful acquire IS the fence — the epoch it minted makes any
        # later write from the dead daemon's lineage refusable, and the
        # arbiter's single-winner steal gives at most one promoted
        # lineage (tdcheck promote model, R2).
        self.promote = promote
        self.events = events
        self.crash_seam = crash_seam
        self.owned: set[tuple[str, str]] = set()
        self.epoch = 0
        self.takeovers_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- protocol steps (thread-free; the model drives these) ----

    def join(self) -> dict:
        out = self.arbiter.join(self.member_id, addr=self.addr)
        self.epoch = out.get("epoch", 0)
        return out

    def fence(self) -> None:
        """Lease lost: every believed ownership is void until
        reacquired through the ring. Dropping the set BEFORE rejoining
        is the fencing order — a member that rejoined first could act
        on stale ownership for one interleaving."""
        if self.owned:
            log.warning("fleet member %s fenced: dropping %d believed "
                        "grant(s)", self.member_id, len(self.owned))
        self.owned.clear()

    def ensure_owned(self, resource: str, name: str) -> dict:
        """Acquire (idempotently) before acting on a resource. Raises
        LeaseError("not-owner"/"held") with the owner hint for the
        caller to surface; fences + rejoins once on a lost lease."""
        for attempt in (0, 1):
            try:
                out = self.arbiter.acquire(resource, name, self.member_id)
                break
            except LeaseError as e:
                if e.reason != "no-lease" or attempt:
                    raise
                self.fence()
                self.join()
        self.crash_seam("fed.after_acquire")
        self.owned.add((resource, name))
        return out

    def release(self, resource: str, name: str) -> None:
        self.arbiter.release(resource, name, self.member_id)
        self.owned.discard((resource, name))

    def heartbeat_once(self) -> dict:
        """Renew + takeover sweep. Returns {"adopted": [...]} naming any
        resources stolen from expired members this pass."""
        try:
            out = self.arbiter.renew(self.member_id)
        except LeaseError as e:
            if e.reason != "no-lease":
                raise
            self.fence()
            out = self.join()
        live = set(out["members"])
        grants = self.arbiter.grants()
        # derive-don't-store: the believed-owned set is rebuilt from the
        # grant table on every beat — a fence emptied it, a restart began
        # empty, a steal-from-us must leave it. Rebind, don't mutate: a
        # concurrent reader sees the old set or the new, never a partial
        # one (a racing ensure_owned's add can land on the old set; the
        # next beat re-derives it — the arbiter, not this cache, is the
        # authority).
        self.owned = {(g["resource"], g["name"]) for g in grants
                      if g["holder"] == self.member_id}
        adopted = []
        for g in grants:
            rid = (g["resource"], g["name"])
            if g["holder"] in live or rid in self.owned:
                continue
            if HashRing.owner_of(f"{g['resource']}/{g['name']}",
                                 live) != self.member_id:
                continue
            try:
                self.arbiter.acquire(g["resource"], g["name"],
                                     self.member_id)
            except LeaseError:
                continue    # lost the steal race — one winner, clean loss
            self.crash_seam("fed.after_takeover")
            self.owned.add(rid)
            self.takeovers_total += 1
            adopted.append(f"{g['resource']}/{g['name']}")
            if self.promote is not None:
                # behind the steal's fencing epoch: install the replica's
                # copy of the record, then adopt reconciles it. A crash
                # between the two is safe — promote is idempotent (it
                # never overwrites a record the local store already has)
                # and the grant is already ours, so the next beat re-runs
                # both (crashpoint fed.after_promote pins this).
                self.promote(g["resource"], g["name"])
                self.crash_seam("fed.after_promote")
                if self.events is not None:
                    self.events.record(
                        "fed.promote",
                        target=f"{g['resource']}/{g['name']}",
                        detail={"holder": self.member_id,
                                "stolenFrom": g["holder"]})
            if self.adopt is not None:
                self.adopt(g["resource"], g["name"])
            if self.events is not None:
                self.events.record(
                    "fed.takeover", target=f"{g['resource']}/{g['name']}",
                    detail={"holder": self.member_id,
                            "stolenFrom": g["holder"]})
        return {"adopted": adopted}

    # ---- daemon thread ----

    def start(self, interval: Optional[float] = None) -> None:
        ttl = getattr(self.arbiter, "ttl", DEFAULT_TTL)
        period = interval if interval is not None else max(0.05, ttl / 3.0)
        self.join()
        self._stop.clear()

        def loop():
            while not self._stop.wait(period):
                try:
                    self.heartbeat_once()
                except Exception:  # noqa: BLE001 — keep the seat alive
                    log.exception("fleet heartbeat failed (%s)",
                                  self.member_id)

        self._thread = threading.Thread(
            target=loop, name=f"fleet-{self.member_id}", daemon=True)
        self._thread.start()

    def stop(self, leave: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if leave:
            try:
                self.arbiter.leave(self.member_id)
            except Exception:  # noqa: BLE001 — best-effort goodbye
                log.debug("fleet leave failed (%s)", self.member_id,
                          exc_info=True)
        self.owned.clear()
