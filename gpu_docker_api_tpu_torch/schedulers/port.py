"""Host port scheduler.

The port's copy of the JAX control plane's schedulers/port.py,
unchanged: the stored state is JAX's, key for key.

Reference parity: internal/schedulers/portscheduler.go — a configurable range
(default 40000-65535, cmd/gpu-docker-api/main.go:36), Apply picks random free
ports (:76-106), GetPortStatus returns the used set + available count
(:137-161). Fixed here: state persists under the ports key on every mutation
(the reference's putToEtcd wrote the *GPU* map under the gpus key, :163-169 —
SURVEY §2 bug 1 — so port state only ever reached etcd at Close).
"""

from __future__ import annotations

import random
from typing import Optional

from .. import xerrors
from ..store.client import StateClient
from ..workqueue import WorkQueue
from .base import Scheduler


class PortScheduler(Scheduler):
    resource = "ports"
    state_key = "portStatusMap"

    DEFAULT_RANGE = (40000, 65535)  # reference default, main.go:36

    def __init__(self, client: Optional[StateClient] = None,
                 wq: Optional[WorkQueue] = None,
                 port_range: Optional[tuple[int, int]] = None,
                 seed: Optional[int] = None):
        super().__init__(client, wq)
        self._rng = random.Random(seed)
        state = self._load_state()
        # explicit port_range overrides stored state (same contract as
        # CpuScheduler.core_count / TpuScheduler.topology)
        if port_range is not None:
            self.start, self.end = port_range
        elif state is not None:
            self.start, self.end = state["range"]
        else:
            self.start, self.end = self.DEFAULT_RANGE
        if self.start > self.end:
            raise ValueError(f"invalid port range ({self.start}, {self.end})")
        # {port: owner} — legacy stored lists become anonymous grants
        raw_used = state["used"] if state is not None else {}
        if isinstance(raw_used, list):
            raw_used = {p: "" for p in raw_used}
        self.used: dict[int, str] = {int(p): o for p, o in raw_used.items()}
        # ports outside a narrowed range stay tracked as used until restored
        with self._lock:
            self._persist()

    @property
    def available_count(self) -> int:
        return self.end - self.start + 1

    def apply(self, n: int, owner: str = "") -> list[int]:
        """Grant n random free ports in range, owned by `owner`."""
        if n <= 0:
            return []
        with self._lock:
            free_count = self.available_count - len(self.used)
            if free_count < n:
                raise xerrors.PortNotEnoughError(
                    f"want {n}, only {free_count} free in "
                    f"[{self.start},{self.end}]")
            grant: list[int] = []
            # random probing with fallback to a linear sweep when dense
            attempts = 0
            while len(grant) < n and attempts < n * 64:
                p = self._rng.randint(self.start, self.end)
                attempts += 1
                if p not in self.used:
                    self.used[p] = owner
                    grant.append(p)
            if len(grant) < n:
                for p in range(self.start, self.end + 1):
                    if p not in self.used:
                        self.used[p] = owner
                        grant.append(p)
                        if len(grant) == n:
                            break
            self._persist()
            return grant

    def restore(self, grant: Optional[list[int]],
                owner: Optional[str] = None) -> None:
        """Owner-checked free (see TpuScheduler.restore)."""
        if not grant:
            return
        with self._lock:
            for p in grant:
                p = int(p)
                if p in self.used and (owner is None or self.used[p] == owner):
                    del self.used[p]
            self._persist()

    def mark_used(self, grant: Optional[list[int]], owner: str = "") -> None:
        """Re-mark ports as held by owner (unwind/reconcile path). Ports
        currently granted to a DIFFERENT owner are left alone."""
        if not grant:
            return
        with self._lock:
            for p in grant:
                p = int(p)
                if self.used.get(p, owner) == owner:
                    self.used[p] = owner
            self._persist()

    def owners(self) -> dict:
        """Locked snapshot of {port: owner} (see Scheduler.owners — the
        port map's ownership lives in `used`, not `status`)."""
        with self._lock:
            return dict(self.used)

    def get_status(self) -> dict:
        """Reference GetPortStatus shape: availableCount already net of used
        (the reference subtracts in the handler, routers/resource.go:33-37 —
        we keep the wire shape but compute it here)."""
        with self._lock:
            return {
                "range": [self.start, self.end],
                "availableCount": self.available_count - len(self.used),
                "usedPortSet": sorted(self.used),
            }

    def serialize(self) -> dict:
        return {"range": [self.start, self.end],
                "used": {str(p): o for p, o in sorted(self.used.items())}}
