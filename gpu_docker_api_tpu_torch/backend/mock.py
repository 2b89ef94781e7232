"""In-memory mock substrate.

The port's copy of the JAX control plane's backend/mock.py, unchanged:
the device paths its health injection keys on are the card scheduler's
(/dev/nvidia<minor>).

Reference parity: the `-tags mock` pair (internal/schedulers/
gpuscheduler_mock.go + internal/services/replicaset_mock.go) which lets the
whole API run on accelerator-less machines. Containers live in a dict;
upper-dirs and volume mountpoints are REAL temp directories so the rolling-
replacement layer-copy and volume-migration machinery is exercised for real.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from typing import Optional

from ..dtos import ContainerSpec
from .base import Backend, ContainerState, VolumeState


class _MockContainer:
    def __init__(self, name: str, spec: ContainerSpec, upper_dir: str):
        self.id = uuid.uuid4().hex[:12]
        self.name = name
        self.spec = spec
        self.upper_dir = upper_dir
        self.running = False
        self.paused = False
        self.exit_code: Optional[int] = None
        self.started_at = 0.0
        self.exec_log: list[list[str]] = []


class MockBackend(Backend):
    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        self._lock = threading.RLock()
        self._containers: dict[str, _MockContainer] = {}
        self._volumes: dict[str, VolumeState] = {}
        self._images: dict[str, str] = {}
        # injectable health state (health.py probes; tests flip these)
        self._ping_ok = True
        self._chip_health: dict[str, bool] = {}
        self._flaps: dict[str, int] = {}
        # injectable quiesce behavior (no real workload to signal):
        # "ok" acks instantly at _quiesce_step, "timeout" refuses,
        # "error" raises a transient error like a flaky substrate would
        self._quiesce_mode = "ok"
        self._quiesce_step = 7
        self.quiesce_log: list[str] = []
        os.makedirs(os.path.join(state_dir, "upper"), exist_ok=True)
        os.makedirs(os.path.join(state_dir, "volumes"), exist_ok=True)

    # ---- injectable health (no real substrate to probe) ----

    def set_ping(self, ok: bool) -> None:
        self._ping_ok = ok

    def ping(self) -> bool:
        return self._ping_ok

    def set_chip_health(self, device_path: str, ok: bool) -> None:
        self._chip_health[device_path] = ok

    def chip_available(self, device_path: str) -> bool:
        return self._chip_health.get(device_path, True)

    def set_flap_count(self, name: str, count: int) -> None:
        self._flaps[name] = count

    def flap_counts(self) -> dict[str, int]:
        return {n: c for n, c in self._flaps.items() if c > 0}

    def set_quiesce(self, mode: str, step: int = 7) -> None:
        """Inject the next quiesce outcome: "ok" | "timeout" | "error"."""
        if mode not in ("ok", "timeout", "error"):
            raise ValueError(f"bad quiesce mode {mode!r}")
        self._quiesce_mode = mode
        self._quiesce_step = step

    def quiesce(self, name: str, timeout: float = 30.0) -> bool:
        import json
        with self._lock:
            c = self._containers.get(name)
            if c is None or not c.running:
                return False
            self.quiesce_log.append(name)
            if self._quiesce_mode == "error":
                raise ConnectionError(f"injected quiesce error on {name}")
            if self._quiesce_mode == "timeout":
                return False
            # instant ack at the injected step, exactly where a real
            # workload would leave it (base.py QUIESCE_ACK contract)
            with open(os.path.join(c.upper_dir, self.QUIESCE_ACK), "w") as f:
                json.dump({"step": self._quiesce_step}, f)
            return True

    # ---- containers ----

    def create(self, name: str, spec: ContainerSpec) -> str:
        with self._lock:
            if name in self._containers:
                raise RuntimeError(f"container {name} already exists")
            upper = os.path.join(self.state_dir, "upper", name)
            os.makedirs(upper, exist_ok=True)
            c = _MockContainer(name, spec, upper)
            self._containers[name] = c
            return c.id

    def start(self, name: str) -> None:
        with self._lock:
            c = self._get(name)
            c.running = True
            c.paused = False
            c.started_at = time.time()

    def stop(self, name: str, timeout: float = 10.0) -> None:
        with self._lock:
            c = self._get(name)
            c.running = False
            c.exit_code = 0

    def pause(self, name: str) -> None:
        with self._lock:
            self._get(name).paused = True

    def restart_inplace(self, name: str) -> None:
        with self._lock:
            c = self._get(name)
            c.running = True
            c.paused = False
            c.started_at = time.time()

    def remove(self, name: str, force: bool = False) -> None:
        with self._lock:
            c = self._containers.get(name)
            if c is None:
                return
            if c.running and not force:
                raise RuntimeError(f"container {name} is running")
            shutil.rmtree(c.upper_dir, ignore_errors=True)
            del self._containers[name]

    def execute(self, name: str, cmd: list[str], workdir: str = "") -> tuple[int, str]:
        with self._lock:
            c = self._get(name)
            if not c.running:
                return 1, "container not running"
            c.exec_log.append(list(cmd))
            return 0, f"mock-exec: {' '.join(cmd)}"

    def inspect(self, name: str) -> ContainerState:
        with self._lock:
            c = self._containers.get(name)
            if c is None:
                return ContainerState(name=name, exists=False)
            return ContainerState(
                name=name, exists=True, running=c.running, paused=c.paused,
                exit_code=c.exit_code, spec=c.spec, upper_dir=c.upper_dir,
                started_at=c.started_at)

    def commit(self, name: str, new_image: str) -> str:
        with self._lock:
            self._get(name)
            img_id = "sha256:" + uuid.uuid4().hex
            self._images[new_image] = img_id
            return img_id

    def list_names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._containers if n.startswith(prefix))

    # ---- volumes ----

    def volume_create(self, name: str, size_bytes: int = 0,
                      tier: str = "") -> VolumeState:
        from .base import resolve_tier_root
        with self._lock:
            if name in self._volumes:
                raise RuntimeError(f"volume {name} already exists")
            root = resolve_tier_root(
                os.path.join(self.state_dir, "volumes"),
                getattr(self, "volume_tiers", {}), tier)
            mp = os.path.join(root, name)
            os.makedirs(mp, exist_ok=True)
            v = VolumeState(name=name, exists=True, mountpoint=mp,
                            size_limit_bytes=size_bytes, tier=tier,
                            driver_opts={"size": size_bytes})
            self._volumes[name] = v
            return v

    def volume_remove(self, name: str) -> None:
        with self._lock:
            v = self._volumes.pop(name, None)
            if v is not None:
                shutil.rmtree(v.mountpoint, ignore_errors=True)

    def volume_list(self) -> list[str]:
        with self._lock:
            return sorted(self._volumes)

    def volume_inspect(self, name: str) -> VolumeState:
        with self._lock:
            v = self._volumes.get(name)
            if v is None:
                return VolumeState(name=name, exists=False)
            from ..utils.file import dir_size
            v.used_bytes = dir_size(v.mountpoint)
            return v

    # ---- helpers ----

    def _get(self, name: str) -> _MockContainer:
        c = self._containers.get(name)
        if c is None:
            raise RuntimeError(f"no such container {name}")
        return c
