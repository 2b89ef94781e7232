"""The node layer's state store: the MVCC engine (mvcc.py), its WAL format
(walio.py) and the typed client over JAX's key space (client.py)."""

from .mvcc import (KeyValue, MVCCStore,  # noqa: F401
                   StoreReadOnlyError, WalCorruptError)
from .client import StateClient, ResourcePrefix  # noqa: F401
from . import walio  # noqa: F401
