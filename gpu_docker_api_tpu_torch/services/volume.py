"""Volume service — versioned volumes with quota and live scale.

The port's copy of the JAX control plane's services/volume.py,
unchanged.

Reference parity: internal/services/volume.go (247 LoC): versioned names
`{name}-{version}` (:72), quota via DriverOpts size (:36-38), shrink guard —
refuse when used > new size (:126-140), patch = create-new + move-data with
the old volume intentionally left alive (:155-159, SURVEY §2 bug 7 — we keep
the semantics but make old-volume GC a flag). Data migration is in-process
(the reference spins a throwaway ubuntu:22.04 container to `mv`,
utils/copy.go:75-128).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .. import xerrors
from ..backend.base import Backend
from ..dtos import HistoryItem, StoredVolumeInfo
from ..faults import crashpoint
from ..intents import KIND_VOLUME, Intent, IntentJournal
from ..obs import trace
from ..store.client import StateClient
from ..utils.copyfast import move_dir_contents
from ..utils.file import to_bytes
from ..version import VersionMap
from ..workqueue import Call, PutKeyValue, WorkQueue

log = logging.getLogger(__name__)

VOLUMES = "volumes"


def _now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


class VolumeService:
    def __init__(self, backend: Backend, client: StateClient, wq: WorkQueue,
                 version_map: VersionMap, delete_old_on_patch: bool = False,
                 intents: Optional[IntentJournal] = None):
        self.backend = backend
        self.client = client
        self.wq = wq
        self.versions = version_map
        self.delete_old_on_patch = delete_old_on_patch
        self.intents = intents if intents is not None else IntentJournal(client)
        self._name_locks: dict[str, threading.Lock] = {}
        self._guard = threading.Lock()
        # read-through cache over write-behind persistence (see ReplicaSetService)
        self._latest: dict[str, StoredVolumeInfo] = {}

    def _mutex(self, name: str) -> threading.Lock:
        with self._guard:
            return self._name_locks.setdefault(name, threading.Lock())

    # ---- create ----

    @trace.traced("svc.volume.create", "name")
    def create_volume(self, name: str, size: str, tier: str = "") -> dict:
        """POST /volumes (reference CreateVolume :26-96). tier selects the
        storage root (local-SSD default vs e.g. an NFS tier)."""
        with self._mutex(name):
            if self.versions.exist(name):
                raise xerrors.VolumeExistedError(name)
            intent = self.intents.begin("volume.create", name,
                                        kind=KIND_VOLUME)
            try:
                out = self._create_version(name, size, tier,
                                           intent=intent, cp="volume.create")
            except Exception:
                intent.done()
                raise
            intent.done(committed=True)
            return out

    def _create_version(self, name: str, size: str, tier: str = "",
                        intent: Optional[Intent] = None,
                        cp: str = "") -> dict:
        version = self.versions.bump(name)
        vol_name = f"{name}-{version}"
        size_bytes = to_bytes(size) if size else 0
        try:
            state = self.backend.volume_create(vol_name, size_bytes,
                                               tier=tier)
        except Exception:
            self.versions.rollback_bump(name, version - 1)
            raise
        if intent is not None:
            intent.step("created", volume=vol_name, version=version)
        if cp:
            crashpoint(f"{cp}.after_backend")
        info = StoredVolumeInfo(version=version, createTime=_now(),
                                volumeName=vol_name, size=size, tier=tier)
        payload = info.serialize()
        self._latest[name] = info
        self.wq.submit(PutKeyValue(VOLUMES, name, payload))
        self.wq.submit(Call(
            lambda: self.client.put_entity_version(VOLUMES, name, version, payload),
            describe=f"persist {VOLUMES}/{name}@{version}"))
        if intent is not None:
            intent.step("persisted", sync=False, volume=vol_name,
                        version=version)
        return {"name": vol_name, "version": version,
                "mountpoint": state.mountpoint, "size": size}

    # ---- patch (scale) ----

    @trace.traced("svc.volume.scale", "name")
    def patch_volume_size(self, name: str, size: str,
                          if_match: Optional[int] = None) -> dict:
        """PATCH /volumes/{name}/size (reference PatchVolumeSize :98-170):
        create `{name}-{v+1}` at the new size, migrate data, repoint.
        if_match: version precondition under the name lock (HTTP 412)."""
        with self._mutex(name):
            info = self._stored_info(name)
            xerrors.PreconditionFailedError.check(name, info.version, if_match)
            new_bytes = to_bytes(size)
            old_bytes = to_bytes(info.size) if info.size else 0
            if new_bytes == old_bytes:
                raise xerrors.NoPatchRequiredError(name)

            old_state = self.backend.volume_inspect(info.volumeName)
            if not old_state.exists:
                raise xerrors.NotExistInStoreError(info.volumeName)
            # shrink guard (reference :126-140)
            if new_bytes < old_bytes and old_state.used_bytes > new_bytes:
                raise xerrors.VolumeSizeUsedGreaterThanReducedError(
                    f"used {old_state.used_bytes}B > target {new_bytes}B")

            intent = self.intents.begin(
                "volume.scale", name, kind=KIND_VOLUME,
                oldVersion=info.version, oldVolume=info.volumeName,
                newSize=size)
            try:
                # a scaled version stays on its tier (data migrates in-tier)
                out = self._create_version(name, size, tier=info.tier,
                                           intent=intent)
                crashpoint("volume.scale.after_create")
            except Exception:
                intent.done()
                raise
            new_state = self.backend.volume_inspect(out["name"])
            try:
                # same-FS rename fast path / parallel cross-FS fallback
                # (utils/copyfast.py); collision-tolerant so the crash
                # reconciler's re-run of a partial move converges
                mv = move_dir_contents(old_state.mountpoint,
                                       new_state.mountpoint)
                intent.step("migrated", movedEntries=mv.files,
                            movedBytes=mv.bytes)
                crashpoint("volume.scale.after_migrate")
            except Exception:
                # migration failed: drop the new version, keep the old live,
                # revert the latest cache/pointer and the per-version key
                log.exception("volume data migration %s -> %s",
                              info.volumeName, out["name"])
                try:
                    self.backend.volume_remove(out["name"])
                except Exception:  # noqa: BLE001
                    # the new volume survives its failed scale: without a
                    # trace here the orphan is invisible until the next
                    # boot reconcile sweeps it
                    log.exception("cleanup: removing failed new volume %s",
                                  out["name"])
                failed_version = self.versions.get(name)
                self.versions.rollback_bump(name, info.version)
                self._latest[name] = info
                self.wq.submit(PutKeyValue(VOLUMES, name, info.serialize()))
                if failed_version is not None:
                    self.wq.submit(Call(
                        lambda v=failed_version: self.client.delete_entity_version(
                            VOLUMES, name, v),
                        describe=f"drop {VOLUMES}/{name}@{failed_version}"))
                intent.done()
                raise
            if self.delete_old_on_patch:
                try:
                    self.backend.volume_remove(info.volumeName)
                except Exception:  # noqa: BLE001
                    log.exception("removing old volume %s", info.volumeName)
            # else: reference behavior — old volume intentionally kept
            # (volume.go:155-159); GC is the operator's call
            intent.done(committed=True)
            return out

    # ---- delete / info / history ----

    @trace.traced("svc.volume.delete", "name")
    def delete_volume(self, name: str, keep_history: bool = False,
                      if_match: Optional[int] = None) -> None:
        """DELETE /volumes/{name} (reference :174-199). keep_history mirrors
        the `?noall` toggle (routers/volume.go:121-127)."""
        with self._mutex(name):
            try:
                info = self._stored_info(name)
            except xerrors.NotExistInStoreError:
                info = None
            xerrors.PreconditionFailedError.check(
                name, info.version if info else 0, if_match)
            intent = self.intents.begin(
                "volume.delete", name, kind=KIND_VOLUME,
                volume=info.volumeName if info else "",
                keepHistory=keep_history)
            try:
                if info is not None:
                    try:
                        self.backend.volume_remove(info.volumeName)
                    except xerrors.BackendUnavailableError:
                        # breaker open: the remove never reached the
                        # substrate — deleting the record anyway would
                        # orphan the real volume behind a refused call
                        raise
                    except Exception:  # noqa: BLE001
                        log.exception("removing volume %s", info.volumeName)
                    intent.step("removed", sync=False)
                    crashpoint("volume.delete.after_remove")
                self._latest.pop(name, None)
                if not keep_history:
                    self.versions.remove(name)
                    self.wq.join()  # drain queued writes before deleting the keys
                    self.client.delete(VOLUMES, name)
                    self.client.delete_entity_versions(VOLUMES, name)
            except Exception:
                intent.done()
                raise
            intent.done(committed=True)

    def get_volume_info(self, name: str) -> dict:
        info = self._stored_info(name)
        out = {
            "version": info.version,
            "createTime": info.createTime,
            "volumeName": info.volumeName,
            "size": info.size,
            "tier": info.tier,
        }
        try:
            state = self.backend.volume_inspect(info.volumeName)
            out["mountpoint"] = state.mountpoint
            out["usedBytes"] = state.used_bytes
        except xerrors.BackendUnavailableError:
            # breaker open: serve what the store knows (degraded read)
            out["mountpoint"] = ""
            out["usedBytes"] = None
            out["degraded"] = True
        return out

    def get_volume_history(self, name: str) -> list[dict]:
        self.wq.join()  # history reads the store; drain write-behind first
        versions = self.client.entity_versions(VOLUMES, name)
        if not versions:
            raise xerrors.NotExistInStoreError(name)
        out = []
        for v, payload in reversed(versions):
            info = StoredVolumeInfo.deserialize(payload)
            out.append(HistoryItem(v, info.createTime, info).to_json())
        return out

    def _stored_info(self, name: str) -> StoredVolumeInfo:
        cached = self._latest.get(name)
        if cached is not None:
            return cached
        info = StoredVolumeInfo.deserialize(self.client.get_value(VOLUMES, name))
        self._latest[name] = info
        return info

    def invalidate(self, name: str) -> None:
        """Drop the latest-info cache entry (reconciler rewrites records)."""
        self._latest.pop(name, None)
