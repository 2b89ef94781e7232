"""ctypes front-end for the C++ MVCC store core (native/mvcc_store.cc).

The port's copy of the JAX control plane's store/native.py. The core is
host code, built by the port's _native.py with g++ into the package's
build/.

Same API and WAL format as the pure-Python MVCCStore — the two are
interchangeable engines behind StateClient. `open_store()` is the factory
the app uses: native when the core is available, Python otherwise.

The core honors `fsync` for real (batched leader/follower group commit,
one fwrite + fsync per batch — the same design as store/mvcc.py), so the
factory no longer demotes to the Python engine when durability is
requested. The hot read path goes through `mvcc_get_fast`/
`mvcc_range_fast`: raw value bytes via a per-handle mmap'd transfer
buffer instead of a JSON round trip plus a malloc per call.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
import time
from typing import Iterable, Optional, Union

from .._native import load
from . import walio
from .mvcc import KeyValue, MVCCStore, StoreReadOnlyError, WalCorruptError


def native_available() -> bool:
    return load("mvccstore") is not None


class NativeMVCCStore:
    """Drop-in MVCCStore backed by the C++ core."""

    def __init__(self, wal_path: Optional[str] = None, fsync: bool = False):
        self._lib = load("mvccstore")
        if self._lib is None:
            raise RuntimeError("native mvcc core unavailable")
        if wal_path:
            os.makedirs(os.path.dirname(os.path.abspath(wal_path)), exist_ok=True)
            # WAL-integrity classification runs HERE, in walio (the single
            # implementation both engines share): a torn tail is truncated
            # before the core opens the file, mid-log corruption refuses
            # the open. The core's own Replay still verifies CRCs and
            # stops at the first bad frame as defense in depth.
            s = walio.scan(wal_path)
            if s.corrupt_at is not None:
                raise WalCorruptError(wal_path, s.corrupt_at, s.detail)
            if s.truncate_to is not None and os.path.exists(wal_path):
                with open(wal_path, "r+b") as f:
                    f.truncate(s.truncate_to)
        self._fsync = bool(fsync)
        # read-only latch policy lives in the wrapper (the core only
        # detects the first failed write: mvcc_read_only -> errno)
        self._ro_probe_at = 0.0
        self._ro_reason: Optional[str] = None
        self._ro_trips = 0
        self._ro_denials = 0
        self._h = self._lib.mvcc_open((wal_path or "").encode(),
                                      1 if fsync else 0)
        # the fast read path returns pointers into the handle's single
        # transfer buffer — valid only until the next *_fast call, so the
        # call + copy-out pair is serialized here (the GIL makes this
        # nearly free; the C core's own mutex still guards its state).
        # The meta arrays are preallocated for the same reason: they are
        # only ever touched under this lock, and a per-call allocation is
        # measurable at the FFI call rate the read path runs at.
        self._read_lock = threading.Lock()
        self._get_meta = (ctypes.c_int64 * 4)()
        self._range_meta = (ctypes.c_int64 * 2)()
        self._get_fast = self._lib.mvcc_get_fast
        self._range_fast = self._lib.mvcc_range_fast

    # ---- helpers ----

    @property
    def _handle(self):
        """Guard against use-after-close: a NULL handle would be a hard
        nullptr dereference in the C++ core (process death, no traceback)."""
        if self._h is None:
            raise RuntimeError("store is closed")
        return self._h

    def _take(self, ptr) -> Optional[str]:
        if not ptr:
            return None
        try:
            return ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.mvcc_free(ptr)

    @staticmethod
    def _kv(d: dict) -> KeyValue:
        return KeyValue(d["key"], d["value"], d["create_revision"],
                        d["mod_revision"], d["version"])

    # ---- read-only degradation (ENOSPC &c; MVCCStore is the spec) ----

    def _check_writable(self) -> None:
        e = self._lib.mvcc_read_only(self._handle)
        if not e:
            return
        remaining = self._ro_probe_at - time.monotonic()
        if remaining > 0:
            self._ro_denials += 1
            raise StoreReadOnlyError(self._ro_reason or f"errno {e}",
                                     max(0.1, remaining))
        # probe window: clear the core's latch and let this mutation try
        # the disk — a failed flush re-arms it (self-healing)
        self._lib.mvcc_clear_read_only(self._handle)

    def _after_write(self) -> None:
        """Raise the typed refusal when this mutation's flush latched the
        core. Memory stays ahead of disk exactly like the Python engine:
        the record is applied + buffered, the caller just got no ack."""
        e = self._lib.mvcc_read_only(self._handle)
        if not e:
            return
        self._ro_reason = f"OSError: [Errno {e}] {os.strerror(e)}"
        self._ro_probe_at = time.monotonic() + MVCCStore.READ_ONLY_PROBE_S
        self._ro_trips += 1
        self._ro_denials += 1
        raise StoreReadOnlyError(self._ro_reason, MVCCStore.READ_ONLY_PROBE_S)

    @property
    def read_only(self) -> Optional[str]:
        if self._lib.mvcc_read_only(self._handle):
            return self._ro_reason or "WAL write failed"
        return None

    @property
    def read_only_trips(self) -> int:
        return self._ro_trips

    @property
    def read_only_denials(self) -> int:
        return self._ro_denials

    @property
    def read_only_retry_s(self) -> float:
        if not self._lib.mvcc_read_only(self._handle):
            return 0.0
        return max(0.1, self._ro_probe_at - time.monotonic())

    # ---- MVCCStore API ----

    def put(self, key: str, value: str) -> int:
        self._check_writable()
        rev = self._lib.mvcc_put(self._handle, key.encode(), value.encode())
        self._after_write()
        return rev

    def put_many(self, items: Iterable[tuple[str, str]]) -> int:
        """Apply all puts under one native lock acquisition and one batch
        commit (single fwrite + optional fsync) — the entry point the
        workqueue's coalescing drainer batches into. Returns the final
        revision (the store's current revision when `items` is empty)."""
        parts = []
        n = 0
        for key, value in items:
            k = key.encode()
            v = value.encode()
            parts.append(struct.pack("<II", len(k), len(v)))
            parts.append(k)
            parts.append(v)
            n += 1
        if n == 0:
            return self.revision
        self._check_writable()
        rev = self._lib.mvcc_put_many(self._handle, b"".join(parts), n)
        self._after_write()
        return rev

    def delete(self, key: str) -> bool:
        self._check_writable()
        ok = bool(self._lib.mvcc_delete(self._handle, key.encode()))
        if ok:
            self._after_write()
        return ok

    # ---- replication apply (store/mvcc.py put_at/delete_at is the spec) ----

    def put_at(self, key: str, value: str, rev: int,
               create_revision: Optional[int] = None,
               version: Optional[int] = None) -> bool:
        self._check_writable()
        cr = -1 if create_revision is None else int(create_revision)
        ver = -1 if version is None else int(version)
        ok = bool(self._lib.mvcc_put_at(self._handle, key.encode(),
                                        value.encode(), int(rev), cr, ver))
        if ok:
            self._after_write()
        return ok

    def delete_at(self, key: str, rev: int) -> bool:
        self._check_writable()
        ok = bool(self._lib.mvcc_delete_at(self._handle, key.encode(),
                                           int(rev)))
        if ok:
            self._after_write()
        return ok

    def get(self, key: str) -> Optional[KeyValue]:
        meta = self._get_meta
        with self._read_lock:
            ptr = self._get_fast(self._handle, key.encode(), meta)
            if meta[0] < 0 or not ptr:
                return None
            raw = ctypes.string_at(ptr, meta[0])
            crev, mrev, ver = meta[1], meta[2], meta[3]
        return KeyValue(key, raw.decode("utf-8"), crev, mrev, ver)

    def get_at_revision(self, key: str, revision: int) -> Optional[KeyValue]:
        ptr = self._lib.mvcc_get_at(self._handle, key.encode(), revision)
        if not ptr:
            raise ValueError(f"revision {revision} compacted")
        d = json.loads(self._take(ptr))
        return self._kv(d) if d else None

    def range(self, prefix: str) -> list[KeyValue]:
        meta = self._range_meta
        with self._read_lock:
            ptr = self._range_fast(self._handle, prefix.encode(), meta)
            if not ptr or meta[1] <= 0:
                return []
            buf = ctypes.string_at(ptr, meta[1])
            count = meta[0]
        out = []
        off = 0
        for _ in range(count):
            klen, vlen, crev, mrev, ver = struct.unpack_from("<IIqqq", buf,
                                                             off)
            off += 32
            key = buf[off:off + klen].decode("utf-8")
            off += klen
            value = buf[off:off + vlen].decode("utf-8")
            off += vlen
            out.append(KeyValue(key, value, crev, mrev, ver))
        return out

    def history(self, key: str, since_create: bool = True) -> list[KeyValue]:
        raw = self._take(self._lib.mvcc_history(
            self._handle, key.encode(), 1 if since_create else 0))
        return [self._kv(d) for d in json.loads(raw or "[]")]

    def get_version(self, key: str, version: int) -> Optional[KeyValue]:
        for kv in self.history(key):
            if kv.version == version:
                return kv
        return None

    @property
    def revision(self) -> int:
        return self._lib.mvcc_revision(self._handle)

    def compact(self, revision: int,
                keep_history_prefixes: tuple[str, ...] = ()) -> int:
        blob = b"".join(p.encode() + b"\0" for p in keep_history_prefixes) + b"\0"
        return self._lib.mvcc_compact(self._handle, revision, blob)

    def snapshot(self, path: str) -> None:
        if not self._lib.mvcc_snapshot(self._handle, path.encode()):
            raise OSError(f"snapshot to {path} failed")

    def backup(self, path: str, revision: Optional[int] = None) -> dict:
        """Point-in-time backup at exact `revision` (default: current) —
        same contract and file format as MVCCStore.backup."""
        target = self.revision if revision is None else int(revision)
        rc = self._lib.mvcc_backup(self._handle, path.encode(), target)
        if rc == -2:
            raise ValueError(f"revision {target} outside the retained "
                             f"range (compacted/ahead of head)")
        if rc < 0:
            raise OSError(f"backup to {path} failed")
        return {"revision": target, "records": rc}

    @property
    def wal_format(self) -> int:
        """0 = legacy v0 JSONL WAL file, 1 = CRC-framed v1 (walio.py)."""
        return self._lib.mvcc_wal_format(self._handle)

    @property
    def wal_records(self) -> int:
        return self._lib.mvcc_wal_records(self._handle)

    # ---- group-commit counters (python-engine parity; /metrics) ----

    @property
    def wal_flushes(self) -> int:
        return self._lib.mvcc_wal_flushes(self._handle)

    @property
    def wal_flushed_records(self) -> int:
        return self._lib.mvcc_wal_flushed_records(self._handle)

    @property
    def wal_flush_batch_max(self) -> int:
        return self._lib.mvcc_wal_flush_batch_max(self._handle)

    def maintain(self, keep_history_prefixes: tuple[str, ...] = ()) -> dict:
        """Compact + WAL rewrite + handle swap, same contract as
        MVCCStore.maintain."""
        blob = (b"".join(p.encode() + b"\0" for p in keep_history_prefixes)
                + b"\0")
        dropped = self._lib.mvcc_maintain(self._handle, blob)
        if dropped < 0:
            raise OSError("WAL rewrite failed during maintain")
        return {"dropped": dropped, "wal_records": self.wal_records}

    def keys(self):
        return iter(sorted(kv.key for kv in self.range("")))

    def close(self) -> None:
        if self._h:
            self._lib.mvcc_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeMVCCStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # noqa: D105 — last-resort handle cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001  # tdlint: disable=silent-swallow -- logging during interpreter teardown is unsafe
            pass


StoreLike = Union[MVCCStore, NativeMVCCStore]


def open_store(wal_path: Optional[str] = None,
               engine: str = "auto",
               fsync: Optional[bool] = None) -> StoreLike:
    """engine: "auto" (native when available), "native", "python".

    fsync (default: the TDAPI_WAL_FSYNC env, off): fsync every commit.
    Affordable on BOTH engines because both group-commit — N concurrent
    writers share one fsync (store/mvcc.py; native/mvcc_store.cc mirrors
    the same leader/follower design). "auto" therefore prefers the native
    engine whenever the core is available, fsync or not."""
    if fsync is None:
        fsync = os.environ.get("TDAPI_WAL_FSYNC", "") not in ("", "0")
    if engine == "python":
        return MVCCStore(wal_path=wal_path, fsync=fsync)
    if engine == "native":
        return NativeMVCCStore(wal_path=wal_path, fsync=fsync)
    if engine != "auto":
        raise ValueError(f"unknown store engine {engine!r} (auto|native|python)")
    if native_available():
        return NativeMVCCStore(wal_path=wal_path, fsync=fsync)
    return MVCCStore(wal_path=wal_path, fsync=fsync)
