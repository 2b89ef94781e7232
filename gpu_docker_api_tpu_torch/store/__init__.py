"""The node layer's state store: the MVCC engines (mvcc.py, the Python
one; native.py, the C++ core's front-end; both write one WAL format),
their WAL format (walio.py) and the typed client over JAX's key space
(client.py). `open_store` picks the engine."""

from .mvcc import (KeyValue, MVCCStore,  # noqa: F401
                   StoreReadOnlyError, WalCorruptError)
from .client import StateClient, ResourcePrefix  # noqa: F401
from .native import NativeMVCCStore, native_available, open_store  # noqa: F401
from . import walio  # noqa: F401
