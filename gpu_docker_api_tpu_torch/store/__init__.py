"""The node layer's state store: the MVCC engine (mvcc.py), its WAL format
(walio.py) and the typed client over JAX's key space (client.py)."""

from .mvcc import (KeyValue, MVCCStore,  # noqa: F401
                   StoreReadOnlyError, WalCorruptError)
from .client import StateClient, ResourcePrefix  # noqa: F401
from . import walio  # noqa: F401


def open_store(wal_path=None, engine: str = "auto", fsync=None) -> MVCCStore:
    """The JAX package's open_store on the one engine the port has.

    engine "auto" and "python" open the Python MVCC engine (the JAX "auto"
    prefers its native core, whose WAL format is this one's); "native"
    raises until the native engine is ported. fsync (default: the
    TDAPI_WAL_FSYNC env, off) fsyncs every group commit."""
    import os
    if fsync is None:
        fsync = os.environ.get("TDAPI_WAL_FSYNC", "") not in ("", "0")
    if engine == "native":
        raise NotImplementedError(
            "the native store engine (native/mvcc_store.cc) is not yet "
            "ported; use engine 'python' or 'auto'")
    if engine not in ("auto", "python"):
        raise ValueError(f"unknown store engine {engine!r} (auto|native|python)")
    return MVCCStore(wal_path=wal_path, fsync=fsync)
