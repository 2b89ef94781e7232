"""Backend seam: the substrate interface the services layer drives.

The port's copy of the JAX control plane's backend/base.py, with three
implementations:

- MockBackend    — in-memory, instant; unit/CI substrate (reference
                   `-tags mock`)
- ProcessBackend — containers are real host processes with the card env
                   grant injected (CUDA_VISIBLE_DEVICES, the worker
                   contract); the node-native substrate and the bench path
- DockerBackend  — dockerd over its Unix socket under the nvidia runtime,
                   the card passed by a CDI DeviceRequest (reference
                   `-tags nvidia`)

and the layer-copy helpers of the rolling replace (copy_container_layer,
precopy_container_layer over utils/copyfast.py).
"""

from __future__ import annotations

import abc
import os
from dataclasses import dataclass, field
from typing import Optional

from ..dtos import ContainerSpec


@dataclass
class ContainerState:
    name: str
    exists: bool = False
    running: bool = False
    paused: bool = False
    exit_code: Optional[int] = None
    spec: Optional[ContainerSpec] = None
    upper_dir: str = ""            # writable-layer dir (overlay2 UpperDir analog)
    started_at: float = 0.0
    pid: Optional[int] = None


@dataclass
class VolumeState:
    name: str
    exists: bool = False
    mountpoint: str = ""
    size_limit_bytes: int = 0
    used_bytes: int = 0
    driver_opts: dict = field(default_factory=dict)
    tier: str = ""                 # storage tier ("" = default/local)


def resolve_tier_root(default_root: str, tiers: dict, tier: str) -> str:
    """Map a volume tier name to its storage root. '' / 'local' is the
    default root; anything else must be configured (--volume-tier NAME=PATH
    — e.g. nfs=/mnt/nfs per the reference's local-SSD + NFS data-disk
    split, README.md:47-51)."""
    if tier in ("", "local"):
        return default_root
    root = (tiers or {}).get(tier)
    if not root:
        raise ValueError(
            f"unknown volume tier {tier!r} — configure it with "
            f"--volume-tier {tier}=PATH (known: {sorted(tiers or {})})")
    # namespace managed volumes under the configured root: a shared export
    # may contain foreign directories that must never be mistaken for (or
    # rmtree'd as) volumes
    return os.path.join(root, "tpu-volumes")


def copy_container_layer(backend: "Backend", old_name: str,
                         new_name: str, snapshot=None):
    """Carry one container's writable layer forward to another (reference
    CopyOldMergedToNewContainerMerged, utils/copy.go:31-46). Shared by the
    rolling-replace step and the crash reconciler's replay of it.

    Without ``snapshot`` this is a full tree clone through the copyfast
    mode ladder (reflink -> copy_file_range -> threaded pool). With a
    ``snapshot`` from :func:`precopy_container_layer` it is the DELTA pass
    of the pre-copy protocol: only files dirtied since the warm copy move,
    and files deleted in between are removed — O(dirty set) inside the
    stop->start window instead of O(layer). Returns the CopyStats when a
    copy actually ran, None when either layer dir is unavailable (falsy,
    preserving the old boolean contract)."""
    from ..utils.copyfast import METRICS, delta_sync, sync_tree
    old_state = backend.inspect(old_name)
    new_state = backend.inspect(new_name)
    if (old_state.exists and new_state.exists
            and old_state.upper_dir and new_state.upper_dir):
        if snapshot is not None:
            stats = delta_sync(old_state.upper_dir, new_state.upper_dir,
                               snapshot)
        else:
            # sync (clone + symlink-protected delete), not a bare clone:
            # the reconciler replays this over a dest a crashed pre-copy
            # may have warm-populated — files the old container deleted
            # since must not ghost into the new layer
            stats = sync_tree(old_state.upper_dir, new_state.upper_dir)
        METRICS.observe_copy(stats)
        return stats
    return None


def precopy_container_layer(backend: "Backend", old_name: str,
                            new_name: str):
    """Warm-copy ``old``'s writable layer into ``new`` while ``old`` is
    still RUNNING (the pre-copy half of the pre-copy/delta replace).
    Returns ``(snapshot, stats)`` to feed the later
    :func:`copy_container_layer` delta pass, or ``None`` when either layer
    dir is unavailable (caller falls back to the in-window full copy)."""
    from ..utils.copyfast import METRICS, clone_tree, snapshot_tree
    old_state = backend.inspect(old_name)
    new_state = backend.inspect(new_name)
    if not (old_state.exists and new_state.exists
            and old_state.upper_dir and new_state.upper_dir):
        return None
    # snapshot BEFORE the warm copy: a write racing the copy then shows as
    # a (size, mtime) mismatch in the delta pass — the safe direction
    snap = snapshot_tree(old_state.upper_dir, new_state.upper_dir)
    stats = clone_tree(old_state.upper_dir, new_state.upper_dir)
    METRICS.observe_copy(stats)
    return snap, stats


class Backend(abc.ABC):
    """Substrate operations (container + volume CRUD + exec)."""

    #: True when every container/volume on the substrate belongs to this
    #: control plane (mock/process own their state dir). False for shared
    #: daemons (dockerd may run other stacks) — the crash reconciler's
    #: orphan sweeps then require store acquaintance with the base name
    #: before any destructive remove, not just a name-shape match.
    exclusive_substrate = True

    # ---- containers ----

    @abc.abstractmethod
    def create(self, name: str, spec: ContainerSpec) -> str:
        """Create (not start) a container; returns its id."""

    @abc.abstractmethod
    def start(self, name: str) -> None: ...

    @abc.abstractmethod
    def stop(self, name: str, timeout: float = 10.0) -> None: ...

    @abc.abstractmethod
    def pause(self, name: str) -> None: ...

    @abc.abstractmethod
    def restart_inplace(self, name: str) -> None:
        """docker-restart semantics (reference Continue/StartupContainer,
        services/replicaset.go:717-732)."""

    @abc.abstractmethod
    def remove(self, name: str, force: bool = False) -> None: ...

    def quiesce(self, name: str, timeout: float = 30.0) -> bool:
        """Workload quiesce contract: deliver a checkpoint-now signal
        (SIGUSR1) to the container's process group and wait up to
        ``timeout`` seconds for the workload to acknowledge by writing the
        ``.quiesced`` ack file into its writable layer root (the workload
        half lives in train.py: finish the in-flight step, save a
        checkpoint plus a durable ``QUIESCED <step>`` marker next to it,
        write the ack, park until stopped).

        Returns True only when the ack appeared in time — the caller
        (services/replicaset.py rolling replace) then knows the layer
        holds a checkpoint at the exact parked step, so the migration
        loses ZERO steps. False means not delivered / not acknowledged
        (container not running, substrate can't signal, workload has no
        handler, or the checkpoint outran the timeout): the caller falls
        back to the plain stop, degrading to at most ``checkpoint-every``
        replayed steps — a quiesce failure must never wedge a drain.

        Base default: unsupported (False). Substrates that can signal
        override it."""
        return False

    #: name of the ack file a quiescing workload writes at its layer root
    QUIESCE_ACK = ".quiesced"

    @abc.abstractmethod
    def execute(self, name: str, cmd: list[str], workdir: str = "") -> tuple[int, str]:
        """Run cmd inside the container; returns (exit_code, combined output)."""

    @abc.abstractmethod
    def inspect(self, name: str) -> ContainerState: ...

    @abc.abstractmethod
    def commit(self, name: str, new_image: str) -> str:
        """Snapshot the container as a new image; returns image id."""

    @abc.abstractmethod
    def list_names(self, prefix: str = "") -> list[str]: ...

    # ---- volumes ----

    @abc.abstractmethod
    def volume_create(self, name: str, size_bytes: int = 0,
                      tier: str = "") -> VolumeState: ...

    @abc.abstractmethod
    def volume_remove(self, name: str) -> None: ...

    @abc.abstractmethod
    def volume_inspect(self, name: str) -> VolumeState: ...

    def volume_list(self) -> list[str]:
        """Names of every volume the substrate holds (reconciler cross-
        check). Substrates that can't enumerate return [] — the reconciler
        then skips orphan-volume detection rather than guessing."""
        return []

    # ---- health hooks (health.py probes these; defaults = healthy) ----

    def ping(self) -> bool:
        """Substrate reachability. Docker pings dockerd; process/mock own
        their substrate in-process and are reachable by construction."""
        return True

    def chip_available(self, device_path: str) -> bool:
        """Is the card behind device_path present and usable? Device-backed
        substrates (process/docker) check path existence; MockBackend makes
        it injectable. Base default: healthy (no device knowledge)."""
        return True

    def flap_counts(self) -> dict[str, int]:
        """container name -> consecutive crash/restart count, for flap
        detection. Substrates without supervision return {}."""
        return {}

    # ---- lifecycle ----

    def close(self) -> None:  # noqa: B027 — optional hook
        pass


def device_path_available(device_path: str) -> bool:
    """Shared card-presence probe for device-backed substrates: the card is
    unhealthy when ITS device node is gone while the host does expose card
    nodes (/dev/nvidia[0-9]*). A host with no card node at all runs a
    virtual topology (a CPU dev box, CI): there is nothing to check, so
    every card reports healthy rather than the monitor cordoning them."""
    from ..topology import card_nodes
    if not card_nodes():
        return True
    return os.path.exists(device_path)
