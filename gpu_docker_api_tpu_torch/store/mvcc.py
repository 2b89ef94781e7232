"""Embedded MVCC versioned key-value store — the etcd of this framework.

The port's copy of the JAX control plane's Python engine
(gpu_docker_api_tpu/store/mvcc.py). The WAL and snapshot format is the
same byte for byte, so a store written by either package opens in the
other with the same keys, values and revisions, and the port's C++ engine
(store/native.py over native/mvcc_store.cc) reads it too.

The reference outsources versioned state to an external etcd 3.x server
(internal/etcd/client.go:13-24) and implements version history by walking raw
MVCC revisions one gRPC Get(WithRev) at a time (internal/etcd/revision.go:18-44)
— O(revisions) round trips, and silently broken by etcd compaction.

This store keeps etcd's data model (global revision counter; per-key
create_revision / mod_revision / version; tombstoned deletes reset version) but
is embedded, lock-protected, WAL-persisted, and exposes history as a single
O(1)-roundtrip call. WAL durability uses leader/follower group commit (etcd's
batched-fsync idea): writers append under the lock, then block until a flush
leader has made their record durable — N concurrent mutations cost one
flush/fsync instead of N (see _commit; docs/performance.md).

WAL integrity (docs/durability.md): new WALs are written in the v1 framed
format (walio.py — magic header + per-record CRC32) so replay can tell a
torn tail (truncate + continue) from mid-log damage (typed WalCorruptError
pointing at the scrub tool). Legacy v0 JSONL files replay and keep
appending v0 (no migration downtime); any rewrite (maintain / snapshot /
backup) upgrades the file to v1. A failed WAL append (ENOSPC &c) latches
the store read-only: the mutation raises StoreReadOnlyError (mapped to
503 + Retry-After by the server), reads keep serving, and a timed
re-probe lets one mutation test the disk again (see _check_writable).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

from . import walio
from .walio import WalCorruptError  # noqa: F401  (re-export: engine API)
from .. import faults
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

# Group-commit batch window in milliseconds: when > 0, the flush leader
# sleeps this long before flushing so more concurrent writers join the
# batch. 0 (default) flushes as soon as a leader picks the batch up —
# latency-optimal, and still amortizes whenever writers actually race.
WAL_BATCH_MS_ENV = "TDAPI_WAL_BATCH_MS"


class StoreReadOnlyError(RuntimeError):
    """A WAL append failed (ENOSPC, I/O error): the store refuses further
    mutations until a timed re-probe succeeds. Reads are unaffected. The
    server maps this to 503 + Retry-After (docs/durability.md)."""

    def __init__(self, reason: str, retry_after: float):
        self.reason = reason
        self.retry_after = retry_after
        super().__init__(f"store is read-only ({reason}); disk re-probe "
                         f"in <= {retry_after:.0f}s")


@dataclass(frozen=True)
class KeyValue:
    key: str
    value: str
    create_revision: int
    mod_revision: int
    version: int  # number of writes since the key's current creation (1-based)


@dataclass
class _Rev:
    mod_revision: int
    create_revision: int
    version: int
    value: str
    tombstone: bool = False


class MVCCStore:
    """Thread-safe embedded MVCC KV store with optional WAL persistence."""

    def __init__(self, wal_path: Optional[str] = None, fsync: bool = False):
        self._lock = threading.RLock()
        self._rev = 0
        self._compacted = 0
        self._log: dict[str, list[_Rev]] = {}
        self._wal_path = wal_path
        self._fsync = fsync
        self._wal = None
        self._wal_records = 0
        # ---- group commit state (guarded by _commit_cond, NOT _lock) ----
        # Writers append WAL records under _lock (buffered, no flush) and
        # receive a sequence number; _commit() then blocks until a flush
        # leader has made that sequence durable. N writers racing through
        # the window share ONE flush/fsync instead of paying N — durability
        # semantics are unchanged (put() still returns only after its
        # record is on disk), only the flush cost is amortized.
        self._commit_cond = threading.Condition()
        self._seq = 0            # records appended (under _lock)
        self._durable_seq = 0    # records flushed (under _commit_cond)
        self._flushing = False   # a leader is mid-flush
        self._flushes = 0
        self._flushed_records = 0
        self._flush_batch_max = 0
        try:
            self._batch_window = max(
                0.0, float(os.environ.get(WAL_BATCH_MS_ENV, "0") or 0)) / 1e3
        except ValueError:
            self._batch_window = 0.0
        # WAL file format: 1 = CRC-framed (walio), 0 = legacy JSONL. An
        # existing v0 file keeps appending v0 (homogeneous files); every
        # rewrite upgrades to v1.
        self._wal_fmt = 1
        # ---- read-only latch (set on WAL append failure; plain
        # attributes — writes are atomic under the GIL and the one
        # read/clear site holds _lock)
        self._ro_reason: Optional[str] = None
        self._ro_probe_at = 0.0
        self._ro_trips = 0
        self._ro_denials = 0
        if wal_path:
            if os.path.exists(wal_path):
                self._replay(wal_path)
            os.makedirs(os.path.dirname(os.path.abspath(wal_path)), exist_ok=True)
            # binary append: BufferedWriter is internally locked, so the
            # flush leader can run without _lock while writers append
            self._wal = open(wal_path, "ab")
            if self._wal_fmt == 1 and os.path.getsize(wal_path) == 0:
                self._wal.write(walio.MAGIC)
                self._wal.flush()

    # ---- write path ----

    def put(self, key: str, value: str) -> int:
        """Write value; returns the new global revision once durable."""
        with self._lock:
            self._check_writable()
            self._rev += 1
            rev = self._rev
            try:
                seq = self._wal_append(
                    {"op": "put", "k": key, "v": value, "r": rev})
            except StoreReadOnlyError:
                # keep the revision minted and the memory state applied:
                # the record may sit in the write buffer and drain on a
                # later successful flush, so memory-ahead-of-disk is the
                # one consistent outcome (disk never diverges from what
                # memory claims). The caller got the error — nothing was
                # acked — and the boot reconciler heals a death here.
                self._apply_put(key, value, rev)
                raise
            self._apply_put(key, value, rev)
        self._commit(seq)
        return rev

    def put_many(self, items) -> int:
        """Apply a batch of (key, value) puts under ONE lock acquisition
        and make them durable with ONE flush (+ fsync when enabled) —
        the batched twin of put() the workqueue's coalescing drainer
        calls. Returns the final revision (the current revision when the
        batch is empty)."""
        seq = 0
        with self._lock:
            self._check_writable()
            for key, value in items:
                self._rev += 1
                try:
                    seq = self._wal_append(
                        {"op": "put", "k": key, "v": value, "r": self._rev},
                        inline_flush=False)
                except StoreReadOnlyError:
                    # same memory-ahead contract as put(); items after
                    # the failure point are neither minted nor applied
                    self._apply_put(key, value, self._rev)
                    raise
                self._apply_put(key, value, self._rev)
            rev = self._rev
            if seq and self._wal is not None and not self._fsync:
                try:
                    self._wal.flush()   # one flush for the whole batch
                except OSError as e:
                    self._set_read_only(e)
        self._commit(seq)
        return rev

    def delete(self, key: str) -> bool:
        """Tombstone the key. Re-creating it later restarts version at 1
        (etcd semantics). Returns False if the key doesn't exist."""
        with self._lock:
            revs = self._log.get(key)
            if not revs or revs[-1].tombstone:
                return False
            self._check_writable()
            self._rev += 1
            try:
                seq = self._wal_append(
                    {"op": "del", "k": key, "r": self._rev})
            except StoreReadOnlyError:
                self._apply_delete(key, self._rev)
                raise
            self._apply_delete(key, self._rev)
        self._commit(seq)
        return True

    # ---- replication apply (replication.py StandbyReplicator) ----

    def put_at(self, key: str, value: str, rev: int,
               create_revision: Optional[int] = None,
               version: Optional[int] = None) -> bool:
        """Install `value` at the EXACT revision `rev` — the replica-side
        twin of put(), applying a peer daemon's watch stream in order.
        Idempotent: a revision at or below the key's latest mod_revision
        (or below the compaction floor) is a no-op returning False, so a
        replicator that crashes between applying and persisting its
        horizon simply re-applies. create_revision/version pin the key's
        lifetime counters when the replica didn't see the whole lifetime
        (resync-from-snapshot); omitted, they derive from the local log
        exactly like put()."""
        with self._lock:
            self._check_writable()
            if rev <= self._compacted:
                return False
            revs = self._log.get(key)
            if revs and revs[-1].mod_revision >= rev:
                return False
            self._rev = max(self._rev, rev)
            rec = {"op": "put", "k": key, "v": value, "r": rev}
            if create_revision is not None and version is not None:
                rec["cr"] = int(create_revision)
                rec["ver"] = int(version)
            try:
                seq = self._wal_append(rec)
            except StoreReadOnlyError:
                self._apply_put(key, value, rev, create_revision, version)
                raise
            self._apply_put(key, value, rev, create_revision, version)
        self._commit(seq)
        return True

    def delete_at(self, key: str, rev: int) -> bool:
        """Tombstone `key` at the exact revision `rev` (see put_at).
        Idempotent the same way; always advances the revision counter so
        the replica's head tracks the peer's even when the delete itself
        is a no-op (key absent: the stream can race a resync)."""
        with self._lock:
            self._check_writable()
            if rev <= self._compacted:
                return False
            revs = self._log.get(key)
            if revs and revs[-1].mod_revision >= rev:
                return False
            self._rev = max(self._rev, rev)
            if not revs or revs[-1].tombstone:
                return False
            try:
                seq = self._wal_append({"op": "del", "k": key, "r": rev})
            except StoreReadOnlyError:
                self._apply_delete(key, rev)
                raise
            self._apply_delete(key, rev)
        self._commit(seq)
        return True

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _apply_put(self, key: str, value: str, rev: int,
                   cr: Optional[int] = None,
                   ver: Optional[int] = None) -> None:
        revs = self._log.setdefault(key, [])
        if cr is not None and ver is not None:
            # exact lifetime counters (backup restore / resync apply)
            revs.append(_Rev(rev, cr, ver, value))
        elif revs and not revs[-1].tombstone:
            last = revs[-1]
            revs.append(_Rev(rev, last.create_revision, last.version + 1, value))
        else:
            revs.append(_Rev(rev, rev, 1, value))

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _apply_delete(self, key: str, rev: int) -> None:
        revs = self._log.setdefault(key, [])
        revs.append(_Rev(rev, 0, 0, "", tombstone=True))

    # ---- read path ----

    def get(self, key: str) -> Optional[KeyValue]:
        with self._lock:
            revs = self._log.get(key)
            if not revs or revs[-1].tombstone:
                return None
            return self._kv(key, revs[-1])

    def get_at_revision(self, key: str, revision: int) -> Optional[KeyValue]:
        """State of `key` as of global `revision` (etcd Get WithRev)."""
        with self._lock:
            if revision < self._compacted:
                raise ValueError(f"revision {revision} compacted (< {self._compacted})")
            revs = self._log.get(key)
            if not revs:
                return None
            best = None
            for r in revs:
                if r.mod_revision <= revision:
                    best = r
                else:
                    break
            if best is None or best.tombstone:
                return None
            return self._kv(key, best)

    def range(self, prefix: str) -> list[KeyValue]:
        """Latest live KVs whose key starts with prefix, sorted by key."""
        with self._lock:
            out = []
            for key in sorted(self._log):
                if key.startswith(prefix):
                    revs = self._log[key]
                    if revs and not revs[-1].tombstone:
                        out.append(self._kv(key, revs[-1]))
            return out

    def history(self, key: str, since_create: bool = True) -> list[KeyValue]:
        """All live revisions of `key` ascending by mod_revision.

        since_create=True limits to the key's current lifetime (everything
        after the last tombstone) — the semantics of the reference's
        GetRevisionRange ModRevision→CreateRevision walk
        (internal/etcd/revision.go:18-44), but as one call instead of
        O(revisions) gRPC round trips.
        """
        with self._lock:
            revs = self._log.get(key)
            if not revs:
                return []
            live: list[KeyValue] = []
            for r in revs:
                if r.tombstone:
                    if since_create:
                        live = []
                else:
                    live.append(self._kv(key, r))
            return live

    def get_version(self, key: str, version: int) -> Optional[KeyValue]:
        """Value at a specific per-key version within the current lifetime
        (reference GetRevision, internal/etcd/revision.go:46-66)."""
        for kv in self.history(key):
            if kv.version == version:
                return kv
        return None

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    # ---- maintenance ----

    def compact(self, revision: int, keep_history_prefixes: tuple[str, ...] = ()) -> int:
        """Drop per-key revisions with mod_revision < revision, keeping each
        key's latest state. Keys under keep_history_prefixes keep full history
        (this is how container/volume version history survives compaction —
        the reference has no answer to this, SURVEY §2 bug 5). Returns the
        number of revision entries dropped."""
        with self._lock:
            self._check_writable()
            dropped = self._compact_locked(revision, keep_history_prefixes)
            # durable: replay must re-apply the compaction, or a restart
            # would resurrect compacted revisions and reset _compacted
            seq = self._wal_append({"op": "compact", "r": revision,
                                    "keep": list(keep_history_prefixes)})
        self._commit(seq)
        return dropped

    # tdlint: disable=unlocked-state -- contract: caller holds _lock
    def _compact_locked(self, revision: int,
                        keep_history_prefixes: tuple[str, ...]) -> int:
        dropped = 0
        for key in list(self._log):
            revs = self._log[key]
            if any(key.startswith(p) for p in keep_history_prefixes):
                continue
            # etcd semantics: keep every revision > R, plus the newest
            # revision <= R (the "floor" — the key's state as of R), so
            # get_at_revision stays correct for all uncompacted revisions.
            floor = None
            for r in revs:
                if r.mod_revision <= revision:
                    floor = r
                else:
                    break
            keep = [r for r in revs if r.mod_revision > revision]
            if floor is not None and not floor.tombstone:
                keep.insert(0, floor)
            dropped += len(revs) - len(keep)
            if keep:
                self._log[key] = keep
            else:
                # fully-compacted tombstoned key: reclaim it entirely
                del self._log[key]
        self._compacted = max(self._compacted, revision)
        return dropped

    def _replaying_compact(self, revision: int,
                           keep_history_prefixes: tuple[str, ...]) -> None:
        self._compact_locked(revision, keep_history_prefixes)

    @property
    def wal_records(self) -> int:
        """Records in the WAL file (replayed + appended since open) — the
        maintenance trigger for the App's WAL-growth bound."""
        with self._lock:
            return self._wal_records

    @property
    def wal_format(self) -> int:
        """0 = legacy v0 JSONL WAL file, 1 = CRC-framed v1 (walio.py)."""
        with self._lock:
            return self._wal_fmt

    def maintain(self, keep_history_prefixes: tuple[str, ...] = ()) -> dict:
        """Bound the WAL: compact in-memory history up to the current
        revision (keys under keep_history_prefixes keep full history), then
        rewrite the WAL file as a snapshot of the pruned state and swap the
        append handle onto it. The rewrite is atomic (tmp + rename); the
        old handle must be swapped because os.replace leaves an open handle
        appending to the unlinked inode — writes there would be lost.

        The reference has no equivalent: it leans on an external etcd's
        auto-compaction, which its own revision walker then breaks under
        (SURVEY §2 bug 5). Returns {"dropped", "wal_records"}."""
        if not self._wal_path:
            return {"dropped": 0, "wal_records": 0}
        with self._lock:
            dropped = self._compact_locked(self._rev, keep_history_prefixes)
            self.snapshot(self._wal_path + ".snap")
            if self._wal is not None:
                self._wal.close()   # flushes — everything appended so far
            try:
                os.replace(self._wal_path + ".snap", self._wal_path)
                self._wal = open(self._wal_path, "ab")
            except OSError:
                # never leave _wal as a closed handle — subsequent puts
                # would half-apply (memory mutated, WAL append raising)
                self._wal = open(self._wal_path, "ab")
                raise
            # the rewrite always produces v1, even over a legacy v0 file —
            # this is the upgrade path (homogeneous files: appends framed
            # from here on)
            self._wal_fmt = 1
            # re-count: the snapshot holds one "rev" record + the live kvs
            # (first line is the format header, not a record)
            with open(self._wal_path, "rb") as f:
                self._wal_records = sum(
                    1 for line in f if line.strip() and line != walio.MAGIC)
            # restore the compaction floor on future replays (the snapshot
            # itself carries only puts) — a no-op prune that sets _compacted
            self._wal_append({"op": "compact", "r": self._compacted,
                              "keep": list(keep_history_prefixes)})
            self._wal.flush()
            # appends can't race this (they need _lock): everything up to
            # _seq is durable — wake any commit waiters parked on the old
            # handle (its close() flushed their records)
            self._mark_durable(self._seq)
            return {"dropped": dropped, "wal_records": self._wal_records}

    # ---- persistence ----

    def _wal_append(self, rec: dict, inline_flush: bool = True) -> int:
        """Append under _lock; returns the record's commit sequence number
        (0 = no WAL, nothing to wait for). fsync mode appends BUFFERED and
        leaves the flush to the group-commit leader; non-fsync mode flushes
        inline — a page-cache flush costs microseconds, less than parking
        the writer on the commit condition variable would. put_many passes
        inline_flush=False and flushes once for the whole batch.

        Records are framed per the file's format (v1 CRC frames / legacy
        v0 lines). An OSError from the write or flush latches the store
        read-only and surfaces as StoreReadOnlyError."""
        if self._wal is None:
            return 0
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        buf = walio.frame(payload) if self._wal_fmt else payload + b"\n"
        mode = faults.disk_fault(self._wal_path) if self._wal_path else ""
        try:
            if mode:
                buf = self._inject_disk_fault(mode, buf)
            self._wal.write(buf)
            if not self._fsync and inline_flush:
                self._wal.flush()
        except OSError as e:
            self._set_read_only(e)
        self._wal_records += 1
        self._seq += 1
        return self._seq

    # contract: caller holds _lock
    def _inject_disk_fault(self, mode: str, buf: bytes) -> bytes:
        """Apply one armed disk-fault mode to this append (faults.py)."""
        if mode == "enospc":
            raise OSError(28, "No space left on device (injected)")
        if mode == "bitflip":
            pos = len(buf) // 2
            return buf[:pos] + bytes([buf[pos] ^ 0x01]) + buf[pos + 1:]
        if mode == "torn_tail":
            # a prefix reaches the disk, then the process "dies" — the
            # InjectedCrash must unwind nothing (BaseException), exactly
            # like the crashpoint machinery
            self._wal.write(buf[:max(1, len(buf) // 2)])
            self._wal.flush()
            raise faults.InjectedCrash(f"disk:torn_tail:{self._wal_path}")
        return buf

    # ---- read-only degradation (ENOSPC &c) ----

    #: seconds a read-only latch denies mutations before letting ONE
    #: through to re-probe the disk (failure re-arms the latch)
    READ_ONLY_PROBE_S = 5.0

    # contract: caller holds _lock (the _commit leader path sets the
    # latch without it: attribute writes are GIL-atomic and the reader
    # tolerates either order)
    def _set_read_only(self, exc: OSError) -> None:
        """Latch read-only and raise the typed refusal (from `exc`)."""
        self._ro_reason = f"{type(exc).__name__}: {exc}"
        self._ro_probe_at = time.monotonic() + self.READ_ONLY_PROBE_S
        self._ro_trips += 1
        self._ro_denials += 1
        raise StoreReadOnlyError(self._ro_reason,
                                 self.READ_ONLY_PROBE_S) from exc

    # contract: caller holds _lock
    def _check_writable(self) -> None:
        if self._ro_reason is None:
            return
        remaining = self._ro_probe_at - time.monotonic()
        if remaining > 0:
            self._ro_denials += 1
            raise StoreReadOnlyError(self._ro_reason, max(0.1, remaining))
        # probe window: clear the latch and let this mutation try the
        # disk — a failed append re-arms it (self-healing, no operator
        # intervention once space returns)
        self._ro_reason = None

    @property
    def read_only(self) -> Optional[str]:
        """The latch reason while read-only, else None (healthz)."""
        return self._ro_reason

    @property
    def read_only_trips(self) -> int:
        """Times the latch tripped (event/metric edge detection)."""
        return self._ro_trips

    @property
    def read_only_denials(self) -> int:
        """Mutations the latch refused. The HTTP layer diffs this across
        a request to surface 503 even when an intermediate layer
        swallowed the typed refusal."""
        return self._ro_denials

    @property
    def read_only_retry_s(self) -> float:
        """Seconds until the next disk re-probe (0 when writable)."""
        if self._ro_reason is None:
            return 0.0
        return max(0.1, self._ro_probe_at - time.monotonic())

    # ---- group commit ----

    def _mark_durable(self, target: int) -> None:
        with self._commit_cond:
            if target > self._durable_seq:
                self._flushes += 1
                batch = target - self._durable_seq
                self._flushed_records += batch
                self._flush_batch_max = max(self._flush_batch_max, batch)
                self._durable_seq = target
            self._commit_cond.notify_all()

    def _commit(self, seq: int) -> None:
        """Block until record `seq` is durable.

        fsync mode is leader/follower group commit: the first waiter to
        find no flush in progress becomes the leader and flushes + fsyncs
        EVERYTHING appended so far; the rest wait on the condition variable
        and are woken durable — N concurrent writers share one fsync. The
        leader never holds _lock, so writers keep appending (and batching
        up for the next flush) while an fsync is on the wire. Non-fsync
        mode flushed inline in _wal_append and only updates the counters
        here.

        Visibility note (fsync mode): the record is applied to memory
        under _lock BEFORE this wait, so a concurrent get() can observe a
        revision whose fsync is still in flight — the WRITER's ack is the
        durability boundary, not other readers' visibility. That matches
        the system's semantics everywhere else: most control-plane state
        persists write-BEHIND (workqueue.py), and the boot reconciler
        heals any power-loss gap between observed and durable state.
        """
        if seq == 0:
            return
        if not self._fsync:
            # already flushed inline by _wal_append (under _lock): just
            # account for it — group commit only pays off when a commit
            # costs an fsync (see docs/performance.md)
            self._mark_durable(seq)
            return
        with self._commit_cond:
            while self._durable_seq < seq:
                if self._flushing:
                    self._commit_cond.wait()
                    continue
                self._flushing = True
                self._commit_cond.release()
                err: Optional[BaseException] = None
                target = 0
                try:
                    if self._batch_window > 0:
                        time.sleep(self._batch_window)
                    target = self._seq  # everything appended so far
                    wal = self._wal
                    if wal is not None:
                        # the leader's flush+fsync is the whole batch's
                        # durability cost: histogram it, and span it on
                        # the leader's own trace (followers' store.put
                        # spans show the wait as their tail)
                        t0 = time.perf_counter()
                        with obs_trace.span("store.wal_flush"):
                            wal.flush()
                            if self._fsync:
                                os.fsync(wal.fileno())
                        obs_metrics.WAL_FLUSH_LATENCY.observe(
                            (time.perf_counter() - t0) * 1e3)
                except ValueError:
                    # handle swapped/closed mid-flush (maintain()/close()):
                    # both flush before closing, so target IS durable
                    pass
                except BaseException as e:  # noqa: BLE001 — must not wedge waiters
                    err = e
                finally:
                    self._commit_cond.acquire()
                    self._flushing = False
                    if err is None and target > self._durable_seq:
                        self._flushes += 1
                        batch = target - self._durable_seq
                        self._flushed_records += batch
                        self._flush_batch_max = max(self._flush_batch_max, batch)
                        self._durable_seq = target
                    self._commit_cond.notify_all()
                if err is not None:
                    if isinstance(err, OSError):
                        # group-commit leader hit the disk error: latch
                        # read-only so the NEXT mutation is refused fast
                        # instead of re-entering a failing flush. Parked
                        # followers retry as leaders, hit the same error,
                        # and surface the same typed refusal — the
                        # "undefined error path under group commit" is
                        # now defined (docs/durability.md).
                        self._set_read_only(err)
                    raise err

    @property
    def wal_flushes(self) -> int:
        """Physical flush()+fsync batches issued — wal_flushed_records /
        wal_flushes is the average group-commit batch size."""
        with self._commit_cond:
            return self._flushes

    @property
    def wal_flushed_records(self) -> int:
        with self._commit_cond:
            return self._flushed_records

    @property
    def wal_flush_batch_max(self) -> int:
        with self._commit_cond:
            return self._flush_batch_max

    # tdlint: disable=unlocked-state -- boot-time only: runs from __init__
    # before any other thread can hold a reference to this store
    def _replay(self, path: str) -> None:
        s = walio.scan(path)
        if s.corrupt_at is not None:
            raise WalCorruptError(path, s.corrupt_at, s.detail)
        if s.truncate_to is not None:
            # torn tail: physically drop the damaged frame so the next
            # append starts at a clean boundary (a v1 reader would
            # otherwise mis-frame every record after it)
            with open(path, "r+b") as tf:
                tf.truncate(s.truncate_to)
        self._wal_fmt = s.fmt
        for payload in s.payloads:
            try:
                rec = json.loads(payload)
            except json.JSONDecodeError:
                if s.fmt == 0:
                    continue  # legacy tolerance (scan pre-filters; belt)
                raise WalCorruptError(
                    path, 0, "CRC-valid frame holds invalid JSON")
            self._wal_records += 1
            rev = rec.get("r", self._rev + 1)
            self._rev = max(self._rev, rev)
            if rec["op"] == "put":
                self._apply_put(rec["k"], rec["v"], rev,
                                rec.get("cr"), rec.get("ver"))
            elif rec["op"] == "del":
                self._apply_delete(rec["k"], rev)
            elif rec["op"] == "compact":
                self._replaying_compact(rev, tuple(rec.get("keep", ())))
            # op == "rev": counter checkpoint only, handled above

    def _write_frames(self, f, records: Iterator[dict]) -> int:
        """Write the v1 header + framed `records` to open binary file
        `f`; returns the record count."""
        n = 0
        f.write(walio.MAGIC)
        for rec in records:
            f.write(walio.frame(
                json.dumps(rec, separators=(",", ":")).encode("utf-8")))
            n += 1
        return n

    def snapshot(self, path: str) -> None:
        """Write a compacted replayable WAL to `path` (latest lifetime of each
        key only), atomically. Always v1-framed; put records carry cr/ver
        so lifetime counters survive the rewrite exactly (a floor entry
        kept by compaction has create_revision/version from revisions the
        snapshot omits)."""
        def records():
            # preserve the global revision counter even when the highest
            # revisions belong to deletes/compacted entries that the snapshot
            # omits — replaying must never re-mint issued revision numbers
            yield {"op": "rev", "r": self._rev}
            for key in sorted(self._log):
                for kv in self.history(key):
                    yield {"op": "put", "k": key, "v": kv.value,
                           "r": kv.mod_revision, "cr": kv.create_revision,
                           "ver": kv.version}

        tmp = path + ".tmp"
        with self._lock, open(tmp, "wb") as f:
            self._write_frames(f, records())
        os.replace(tmp, path)

    def backup(self, path: str, revision: Optional[int] = None) -> dict:
        """Consistent point-in-time backup at an exact revision — the
        retained history (tombstones included) at-or-below `revision`
        (default: current), written atomically as a v1-framed replayable
        WAL. Restore is file placement: the backup IS a WAL either engine
        opens, reconstructing identical revision history (cr/ver fields
        pin lifetime counters across the compaction floor). Atomic under
        MVCC: one lock acquisition snapshots an exact revision even while
        writers race. Returns {revision, records, compacted}."""
        with self._lock:
            target = self._rev if revision is None else int(revision)
            if target > self._rev:
                raise ValueError(f"revision {target} is ahead of the "
                                 f"store (at {self._rev})")
            if target < self._compacted:
                raise ValueError(f"revision {target} compacted "
                                 f"(< {self._compacted})")
            entries = []
            for key, revs in self._log.items():
                for r in revs:
                    if r.mod_revision <= target:
                        entries.append((r.mod_revision, key, r))
            entries.sort(key=lambda t: t[0])

            def records():
                yield {"op": "rev", "r": target}
                # floor record FIRST: replaying it on the still-empty
                # store sets the compaction floor without dropping the
                # retained sub-floor entries (keep-prefix keys retain
                # full history a compact-after would destroy)
                yield {"op": "compact", "r": self._compacted, "keep": []}
                for mod, key, r in entries:
                    if r.tombstone:
                        yield {"op": "del", "k": key, "r": mod}
                    else:
                        yield {"op": "put", "k": key, "v": r.value,
                               "r": mod, "cr": r.create_revision,
                               "ver": r.version}

            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                n = self._write_frames(f, records())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return {"revision": target, "records": n,
                    "compacted": self._compacted}

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())
                self._wal.close()
                self._wal = None
            # wake any commit waiters: the final flush covered them
            self._mark_durable(self._seq)

    def __enter__(self) -> "MVCCStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- helpers ----

    @staticmethod
    def _kv(key: str, r: _Rev) -> KeyValue:
        return KeyValue(key, r.value, r.create_revision, r.mod_revision, r.version)

    def keys(self) -> Iterator[str]:
        with self._lock:
            live = [k for k, revs in self._log.items() if revs and not revs[-1].tombstone]
        return iter(sorted(live))
