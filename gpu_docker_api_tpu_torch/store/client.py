"""High-level state client: key scheme + typed history ops.

Reference parity: internal/etcd/common.go (key scheme `/gpu-docker-api/apis/v1/
{resource}/{name}` :96-98, Put/GetValue/Del :45-70) and internal/etcd/revision.go
(GetRevisionRange :18-44, GetRevision :46-66). Here the store is embedded, so
ops are in-process calls; history rides MVCCStore.history() instead of a
revision-walk of gRPC gets.

The port keeps the JAX control plane's key space (ResourcePrefix) key for
key, so either package's daemon reads the other's records: the card
scheduler persists under the same `tpus/tpuStatusMap` key its JAX twin
does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from .. import xerrors
from ..obs import metrics as obs_metrics
from ..obs import trace
from .mvcc import KeyValue, MVCCStore


class ResourcePrefix:
    """Key-space layout, mirroring the reference's single prefix but versioned
    for this project. The names are the JAX package's, unchanged."""

    Base = "/tpu-docker-api/apis/v1"
    Containers = "containers"
    Volumes = "volumes"
    Tpus = "tpus"
    Cpus = "cpus"
    Ports = "ports"
    Versions = "versions"
    Merges = "merges"


def resource_key(resource: str, name: str) -> str:
    return f"{ResourcePrefix.Base}/{resource}/{name}"


# Key prefixes whose MVCC history must survive compaction: the per-entity
# version keys (the durable rollback record) and the primary container/volume
# keys (whose in-key history backs get_revision_range — the reference-parity
# view that etcd compaction silently destroys in the reference, SURVEY §2
# bug 5). Everything else — scheduler status maps, version maps, merges —
# churns on every mutation and only needs its latest value.
KEEP_HISTORY_PREFIXES = (
    f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/",
    f"{ResourcePrefix.Base}/{ResourcePrefix.Containers}/",
    f"{ResourcePrefix.Base}/{ResourcePrefix.Volumes}/",
)


@dataclass(frozen=True)
class Combine:
    """One history entry: per-key version + global revision + raw value
    (reference internal/etcd/revision.go combine struct)."""
    version: int
    revision: int
    value: str


class StateClient:
    """Typed facade over MVCCStore used by services, schedulers and version maps."""

    def __init__(self, store: MVCCStore):
        self.store = store

    # ---- basic ops (etcd/common.go parity) ----

    def put(self, resource: str, name: str, value: str) -> int:
        """Synchronous durable write: the caller blocks until its record
        is committed (group-commit wait included), so the span/histogram
        here is the store latency a mutation actually pays."""
        t0 = time.perf_counter()
        with trace.span("store.put", target=f"{resource}/{name}"):
            rev = self.store.put(resource_key(resource, name), value)
        obs_metrics.STORE_PUT_LATENCY.observe(
            (time.perf_counter() - t0) * 1e3)
        return rev

    def put_many(self, puts: list[tuple[str, str, str]]) -> int:
        """Batch of (resource, name, value) writes in one store commit:
        one lock acquisition, one WAL flush (+ one fsync when enabled)
        instead of N — the workqueue drainer's coalesced-sweep entry
        point. Ordering within the batch is preserved. Returns the final
        revision."""
        if not puts:
            return self.store.revision
        items = [(resource_key(r, n), v) for r, n, v in puts]
        t0 = time.perf_counter()
        with trace.span("store.put_many", target=f"{len(items)} keys"):
            rev = self.store.put_many(items)
        obs_metrics.STORE_PUT_LATENCY.observe(
            (time.perf_counter() - t0) * 1e3)
        return rev

    def get_value(self, resource: str, name: str) -> str:
        kv = self.store.get(resource_key(resource, name))
        if kv is None:
            raise xerrors.NotExistInStoreError(f"{resource}/{name}")
        return kv.value

    def get(self, resource: str, name: str) -> Optional[KeyValue]:
        return self.store.get(resource_key(resource, name))

    def delete(self, resource: str, name: str) -> bool:
        with trace.span("store.delete", target=f"{resource}/{name}"):
            return self.store.delete(resource_key(resource, name))

    def range(self, resource: str) -> list[KeyValue]:
        return self.store.range(f"{ResourcePrefix.Base}/{resource}/")

    # ---- history (etcd/revision.go parity, compaction-safe) ----

    def get_revision_range(self, resource: str, name: str) -> list[Combine]:
        """All versions of the key's current lifetime, newest first (the
        reference walker returns newest-to-oldest, revision.go:18-44)."""
        hist = self.store.history(resource_key(resource, name))
        if not hist:
            raise xerrors.NotExistInStoreError(f"{resource}/{name}")
        return [Combine(kv.version, kv.mod_revision, kv.value) for kv in reversed(hist)]

    def get_revision(self, resource: str, name: str, version: int) -> Combine:
        """The value at per-key `version` (revision.go:46-66)."""
        kv = self.store.get_version(resource_key(resource, name), version)
        if kv is None:
            raise xerrors.VersionNotFoundError(f"{resource}/{name}@{version}")
        return Combine(kv.version, kv.mod_revision, kv.value)

    # ---- explicit per-entity-version keys ----
    # The reference equates "container version N" with "the Nth etcd write of
    # the key" — fragile (any incidental rewrite shifts history; compaction
    # destroys it, SURVEY §2 bug 5). We persist every entity version under its
    # own key as the durable system of record, and keep the MVCC walk only as
    # a secondary view.

    def put_entity_version(self, resource: str, name: str, version: int, value: str) -> int:
        return self.store.put(
            f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/{resource}/{name}/{version:012d}", value)

    def get_entity_version(self, resource: str, name: str, version: int) -> str:
        kv = self.store.get(
            f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/{resource}/{name}/{version:012d}")
        if kv is None:
            raise xerrors.VersionNotFoundError(f"{resource}/{name}@{version}")
        return kv.value

    def entity_versions(self, resource: str, name: str) -> list[tuple[int, str]]:
        """[(version, value)] ascending."""
        prefix = f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/{resource}/{name}/"
        out = []
        for kv in self.store.range(prefix):
            out.append((int(kv.key[len(prefix):]), kv.value))
        return out

    def delete_entity_version(self, resource: str, name: str, version: int) -> bool:
        return self.store.delete(
            f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/{resource}/{name}/{version:012d}")

    def delete_entity_versions(self, resource: str, name: str) -> int:
        prefix = f"{ResourcePrefix.Base}/{ResourcePrefix.Versions}/{resource}/{name}/"
        n = 0
        for kv in self.store.range(prefix):
            self.store.delete(kv.key)
            n += 1
        return n
