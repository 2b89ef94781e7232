"""Locate (and lazily build) the native host cores.

The port's copy of the JAX control plane's _native.py, for its three
cores: the MVCC store (store/native.py), the topology box search
(schedulers/gpu.py's native finder) and the shared-memory atomics of the
SO_REUSEPORT data-plane workers (server/workers.py, obs/shm_metrics.py).
Their sources are the repo's host C++ files under `native/`, each compiled
as it is with `g++` into the package's gitignored `build/` (beside the CUDA
kernels of _build.py), named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one is reused. The repo's
`native/build/` belongs to the JAX package's loader and is neither read
nor written here.

A build that cannot run (no compiler) or fails degrades quietly, as JAX's
loader does: `load()` answers None and the callers keep their Python
paths (the Python store engine, the Python box search, the in-process
data plane). A failed build leaves a marker so later processes do not
rerun a doomed compile. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parent.parent
_BUILD = Path(__file__).resolve().parent / "build"
_lock = threading.Lock()
_cache: dict[str, Optional[ctypes.CDLL]] = {}

#: lib name -> its source under native/
_LIB_SOURCES = {"mvccstore": "mvcc_store.cc",
                "topoalloc": "topology_alloc.cc",
                "shmatomics": "shm_atomics.cc"}
CXX_FLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-shared")

#: one symbol per lib that only the CURRENT C ABI exports — the load-time
#: canary that keeps a stale build from binding the argtypes below to an
#: older ABI (a segfault, not a clean error)
_ABI_CANARY = {"mvccstore": "mvcc_put_at",
               "topoalloc": "topo_find_box",
               "shmatomics": "shm_cells_publish"}


def lib_path(name: str) -> Path:
    """Where `name`'s library is (or will be) built."""
    src = _REPO / "native" / _LIB_SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> Optional[ctypes.CDLL]:
    """name: "mvccstore" | "topoalloc" | "shmatomics". Returns the CDLL
    or None."""
    return _load(name, nogil=False)


def load_nogil(name: str) -> Optional[ctypes.CDLL]:
    """Same library via ctypes.PyDLL: calls do NOT release the GIL.

    For sub-microsecond atomic ops (the shm metric shards' fetch-adds)
    a CDLL call's GIL release/reacquire is the dominant cost — and on a
    busy multi-threaded server every release is a scheduler yield point
    that can hand the thread's whole 5ms switch interval away. PyDLL
    keeps the GIL held across the call, which is only correct because
    these ops never block. NEVER route a blocking call (futex_wait,
    store flush) through this handle — it would freeze every thread in
    the process for the wait's duration."""
    return _load(name, nogil=True)


def _load(name: str, nogil: bool) -> Optional[ctypes.CDLL]:
    with _lock:
        key = f"{name}:nogil" if nogil else name
        if key in _cache:
            return _cache[key]
        lib = None
        try:
            path = lib_path(name)
        except (KeyError, OSError):
            path = None
        if path is not None and not path.exists():
            _try_build(name, path)
        if path is not None and path.exists():
            try:
                lib = (ctypes.PyDLL if nogil else ctypes.CDLL)(str(path))
                getattr(lib, _ABI_CANARY[name])
                _declare(name, lib)
            except (OSError, AttributeError):
                lib = None
        _cache[key] = lib
        return lib


def _try_build(name: str, out: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return
    marker = out.with_suffix(".failed")
    if marker.exists():
        return
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp),
             str(_REPO / "native" / _LIB_SOURCES[name])],
            capture_output=True, timeout=120, check=False)
        if proc.returncode == 0:
            os.replace(tmp, out)       # atomic: racing builds agree
        else:
            marker.write_text(proc.stderr.decode("utf-8", "replace")[-2000:])
    except (OSError, subprocess.TimeoutExpired):
        pass
    finally:
        if tmp.exists():
            tmp.unlink()


def _declare(name: str, lib: ctypes.CDLL) -> None:
    c = ctypes
    if name == "mvccstore":
        lib.mvcc_open.restype = c.c_void_p
        lib.mvcc_open.argtypes = [c.c_char_p, c.c_int]
        lib.mvcc_close.argtypes = [c.c_void_p]
        lib.mvcc_put.restype = c.c_int64
        lib.mvcc_put.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
        lib.mvcc_put_many.restype = c.c_int64
        lib.mvcc_put_many.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        lib.mvcc_delete.restype = c.c_int
        lib.mvcc_delete.argtypes = [c.c_void_p, c.c_char_p]
        # fast read path: raw bytes through the handle's mmap'd transfer
        # buffer (NOT freed by the caller; serialized by the wrapper)
        lib.mvcc_get_fast.restype = c.c_void_p
        lib.mvcc_get_fast.argtypes = [c.c_void_p, c.c_char_p,
                                      c.POINTER(c.c_int64)]
        lib.mvcc_range_fast.restype = c.c_void_p
        lib.mvcc_range_fast.argtypes = [c.c_void_p, c.c_char_p,
                                        c.POINTER(c.c_int64)]
        lib.mvcc_get_at.restype = c.c_void_p
        lib.mvcc_get_at.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        lib.mvcc_history.restype = c.c_void_p
        lib.mvcc_history.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
        lib.mvcc_compact.restype = c.c_int64
        lib.mvcc_compact.argtypes = [c.c_void_p, c.c_int64, c.c_char_p]
        lib.mvcc_snapshot.restype = c.c_int
        lib.mvcc_snapshot.argtypes = [c.c_void_p, c.c_char_p]
        lib.mvcc_maintain.restype = c.c_int64
        lib.mvcc_maintain.argtypes = [c.c_void_p, c.c_char_p]
        lib.mvcc_wal_records.restype = c.c_int64
        lib.mvcc_wal_records.argtypes = [c.c_void_p]
        lib.mvcc_wal_flushes.restype = c.c_int64
        lib.mvcc_wal_flushes.argtypes = [c.c_void_p]
        lib.mvcc_wal_flushed_records.restype = c.c_int64
        lib.mvcc_wal_flushed_records.argtypes = [c.c_void_p]
        lib.mvcc_wal_flush_batch_max.restype = c.c_int64
        lib.mvcc_wal_flush_batch_max.argtypes = [c.c_void_p]
        lib.mvcc_revision.restype = c.c_int64
        lib.mvcc_revision.argtypes = [c.c_void_p]
        lib.mvcc_free.argtypes = [c.c_void_p]
        # replica-side exact-revision applies, point-in-time backup,
        # the read-only detector, the WAL format
        lib.mvcc_put_at.restype = c.c_int
        lib.mvcc_put_at.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                    c.c_int64, c.c_int64, c.c_int64]
        lib.mvcc_delete_at.restype = c.c_int
        lib.mvcc_delete_at.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        lib.mvcc_backup.restype = c.c_int64
        lib.mvcc_backup.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        lib.mvcc_read_only.restype = c.c_int
        lib.mvcc_read_only.argtypes = [c.c_void_p]
        lib.mvcc_clear_read_only.restype = None
        lib.mvcc_clear_read_only.argtypes = [c.c_void_p]
        lib.mvcc_wal_format.restype = c.c_int
        lib.mvcc_wal_format.argtypes = [c.c_void_p]
    elif name == "topoalloc":
        lib.topo_find_box.restype = c.c_int
        lib.topo_find_box.argtypes = [
            c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_int8), c.c_int, c.POINTER(c.c_int32)]
    elif name == "shmatomics":
        lib.shm_load.restype = c.c_int64
        lib.shm_load.argtypes = [c.c_void_p]
        lib.shm_store.restype = None
        lib.shm_store.argtypes = [c.c_void_p, c.c_int64]
        lib.shm_add.restype = c.c_int64      # returns the NEW value
        lib.shm_add.argtypes = [c.c_void_p, c.c_int64]
        lib.shm_cas.restype = c.c_int
        lib.shm_cas.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
        lib.shm_hist_observe.restype = None
        lib.shm_hist_observe.argtypes = [c.c_void_p, c.c_int64,
                                         c.c_int64, c.c_int64]
        lib.shm_futex_wait.restype = c.c_int
        lib.shm_futex_wait.argtypes = [c.c_void_p, c.c_uint32, c.c_int64]
        lib.shm_futex_wake.restype = c.c_int
        lib.shm_futex_wake.argtypes = [c.c_void_p, c.c_int]
        # KV-affinity sketch cells: mini-seqlock group publish/read
        lib.shm_cells_publish.restype = c.c_int
        lib.shm_cells_publish.argtypes = [c.c_void_p, c.c_void_p,
                                          c.POINTER(c.c_int64), c.c_int64]
        lib.shm_cells_read.restype = c.c_int
        lib.shm_cells_read.argtypes = [c.c_void_p, c.c_void_p,
                                       c.POINTER(c.c_int64), c.c_int64]
