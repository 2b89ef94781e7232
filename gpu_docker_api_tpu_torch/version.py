"""Name → latest-version maps and the merged-layer map.

The port's copy of the JAX control plane's version.py, unchanged: the
maps persist under JAX's keys, so either package's daemon reads them.

Reference parity: internal/version/version.go (ContainerVersionMap /
VolumeVersionMap :11-14, etcd load at boot :28-41/:94-109, async persist on
every Set/Remove :59-92, flush at Stop :43-51) and internal/version/merge.go
(version→mergedLayerPath, persisted only at Close :28-33).

Fixes over the reference:
- the maps are mutex-protected (the reference's are bare Go maps mutated from
  request goroutines — a latent data race, SURVEY §5.2);
- each map persists only itself (the reference persists BOTH maps on any
  change of either, version.go:81-92 — SURVEY §2 bug 6);
- bump() is atomic get+increment, so two concurrent runs can't mint the same
  version.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Optional

from .store.client import StateClient
from .workqueue import PutKeyValue, WorkQueue

CONTAINER_VERSION_MAP_KEY = "containerVersionMap"
VOLUME_VERSION_MAP_KEY = "volumeVersionMap"
MERGE_MAP_KEY = "containerMergeMap"
_MAPS_RESOURCE = "maps"


class VersionMap:
    def __init__(self, map_key: str, client: StateClient, wq: Optional[WorkQueue] = None):
        self._key = map_key
        self._client = client
        self._wq = wq
        self._lock = threading.Lock()
        self._m: dict[str, int] = {}
        self._load()

    def _load(self) -> None:
        kv = self._client.get(_MAPS_RESOURCE, self._key)
        if kv is not None:
            try:
                self._m = {k: int(v) for k, v in json.loads(kv.value).items()}
            except (json.JSONDecodeError, ValueError, AttributeError):
                self._m = {}

    # ---- reference API shape: Set/Get/Exist/Remove ----

    def get(self, name: str) -> Optional[int]:
        with self._lock:
            return self._m.get(name)

    def exist(self, name: str) -> bool:
        with self._lock:
            return name in self._m

    # Persisting while still holding the lock keeps snapshot order == persist
    # order; submitting outside it would let an older snapshot land last.

    def set(self, name: str, version: int) -> None:
        with self._lock:
            self._m[name] = version
            self._persist(dict(self._m))

    def bump(self, name: str) -> int:
        """Atomically assign the next version (first version is 1)."""
        with self._lock:
            v = self._m.get(name, 0) + 1
            self._m[name] = v
            self._persist(dict(self._m))
            return v

    def rollback_bump(self, name: str, to_version: int) -> None:
        """Undo a failed bump (reference defer at replicaset_nomock.go:45-55)."""
        with self._lock:
            if to_version <= 0:
                self._m.pop(name, None)
            else:
                self._m[name] = to_version
            self._persist(dict(self._m))

    def remove(self, name: str) -> None:
        with self._lock:
            self._m.pop(name, None)
            self._persist(dict(self._m))

    def items(self) -> dict[str, int]:
        with self._lock:
            return dict(self._m)

    # ---- persistence ----

    def _persist(self, snapshot: dict[str, int]) -> None:
        payload = json.dumps(snapshot, sort_keys=True)
        if self._wq is not None:
            self._wq.submit(PutKeyValue(_MAPS_RESOURCE, self._key, payload))
        else:
            self._client.put(_MAPS_RESOURCE, self._key, payload)

    # tdlint: disable=io-under-lock -- deliberate: shutdown flush writes
    # under the lock so a concurrent mutation's persist can't be overwritten
    def flush(self) -> None:
        with self._lock:
            self._client.put(_MAPS_RESOURCE, self._key,
                             json.dumps(self._m, sort_keys=True))


class MergeMap:
    """container-version-name → merged-layer (upper-dir snapshot) path.

    Reference: internal/version/merge.go. Persisted on every mutation here
    (the reference persists only at Close — a crash loses it)."""

    def __init__(self, client: StateClient, wq: Optional[WorkQueue] = None):
        self._client = client
        self._wq = wq
        self._lock = threading.Lock()
        self._m: dict[str, str] = {}
        kv = self._client.get(_MAPS_RESOURCE, MERGE_MAP_KEY)
        if kv is not None:
            try:
                self._m = dict(json.loads(kv.value))
            except json.JSONDecodeError:
                self._m = {}

    def get(self, container_name: str) -> Optional[str]:
        with self._lock:
            return self._m.get(container_name)

    def set(self, container_name: str, path: str) -> None:
        with self._lock:
            self._m[container_name] = path
            self._persist(dict(self._m))

    def remove_replicaset(self, replicaset_name: str) -> list[str]:
        """Drop all entries for versions of one replicaSet; returns removed
        paths (reference deletes the whole merges/{rs} dir on container
        delete, replicaset.go:706-715). Matches `{name}-{digits}` exactly —
        replicaSet names may not contain dashes, but don't rely on that."""
        pat = re.compile(re.escape(replicaset_name) + r"-\d+$")
        with self._lock:
            gone = [p for n, p in self._m.items() if pat.fullmatch(n)]
            self._m = {n: p for n, p in self._m.items() if not pat.fullmatch(n)}
            self._persist(dict(self._m))
        return gone

    def items(self) -> dict[str, str]:
        with self._lock:
            return dict(self._m)

    def _persist(self, snapshot: dict[str, str]) -> None:
        payload = json.dumps(snapshot, sort_keys=True)
        if self._wq is not None:
            self._wq.submit(PutKeyValue(_MAPS_RESOURCE, MERGE_MAP_KEY, payload))
        else:
            self._client.put(_MAPS_RESOURCE, MERGE_MAP_KEY, payload)

    # tdlint: disable=io-under-lock -- deliberate: shutdown flush writes
    # under the lock so a concurrent mutation's persist can't be overwritten
    def flush(self) -> None:
        with self._lock:
            self._client.put(_MAPS_RESOURCE, MERGE_MAP_KEY,
                             json.dumps(self._m, sort_keys=True))
