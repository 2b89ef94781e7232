"""CPU core scheduler.

The port's copy of the JAX control plane's schedulers/cpu.py,
unchanged: the stored state is JAX's, key for key.

Reference parity: internal/schedulers/cpuscheduler.go — logical core count
from /proc/cpuinfo (:18, :169-186), Apply returns a sorted comma cpuset
string for HostConfig.CpusetCpus (:77-116). Fixes SURVEY §2 bug 4: restore
of an empty cpuset is a no-op instead of polluting the map with "".
"""

from __future__ import annotations

import os
from typing import Optional, Union

from .. import xerrors
from ..store.client import StateClient
from ..workqueue import WorkQueue
from .base import FREE, Scheduler, _norm_owner, merge_stored_status


def _probe_core_count() -> int:
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            n = sum(1 for line in f if line.startswith("processor"))
        if n:
            return n
    except OSError:
        pass
    return os.cpu_count() or 1


class CpuScheduler(Scheduler):
    resource = "cpus"
    state_key = "cpuStatusMap"

    def __init__(self, client: Optional[StateClient] = None,
                 wq: Optional[WorkQueue] = None,
                 core_count: Optional[int] = None):
        super().__init__(client, wq)
        state = self._load_state()
        if state is not None and core_count is None:
            self.status = {int(k): _norm_owner(v) for k, v in state.items()}
        else:
            n = core_count if core_count is not None else _probe_core_count()
            self.status = merge_stored_status(state, {i: FREE for i in range(n)})
        with self._lock:
            self._persist()

    @staticmethod
    def _cores(grant: Union[str, list[int], None]) -> list[int]:
        if not grant:
            return []
        return ([int(x) for x in grant.split(",") if x.strip() != ""]
                if isinstance(grant, str) else list(grant))

    def apply(self, n: int, owner: str = "",
              reuse: Union[str, list[int], None] = None) -> str:
        """Grant n cores; returns a cpuset string "0,1,5" (sorted). See
        TpuScheduler.apply for owner/reuse semantics."""
        if n <= 0:
            return ""
        with self._lock:
            reusable = {i for i in self._cores(reuse)
                        if self.status.get(i) == owner}
            free = sorted({i for i, s in self.status.items() if s is FREE}
                          | reusable)
            if len(free) < n:
                raise xerrors.CpuNotEnoughError(
                    f"want {n}, only {len(free)} of {len(self.status)} free")
            # prefer reused cores to minimize churn, then lowest-index free
            grant = sorted(sorted(reusable)[:n] +
                           [i for i in free if i not in reusable][:max(0, n - len(reusable))])
            for i in grant:
                self.status[i] = owner
            self._persist()
            return ",".join(str(i) for i in grant)

    def restore(self, grant: Union[str, list[int], None],
                owner: Optional[str] = None) -> None:
        """Free a cpuset string or core list, owner-checked. Empty/None is a
        no-op (reference splits "" into [""] and corrupts the map —
        cpuscheduler.go:132-138 via replicaset.go:145)."""
        if not grant:
            return
        with self._lock:
            for i in self._cores(grant):
                if i in self.status and (owner is None or self.status[i] == owner):
                    self.status[i] = FREE
            self._persist()

    def mark_used(self, grant: Union[str, list[int], None],
                  owner: str = "") -> None:
        """Re-mark cores as held by owner (unwind path)."""
        if not grant:
            return
        with self._lock:
            for i in self._cores(grant):
                if i in self.status and self.status[i] in (FREE, owner):
                    self.status[i] = owner
            self._persist()

    def get_status(self) -> dict:
        with self._lock:
            used = sorted(i for i, s in self.status.items() if s is not FREE)
            return {
                "totalCount": len(self.status),
                "usedCount": len(used),
                "usedCores": used,
            }

    def serialize(self) -> dict:
        return {str(k): v for k, v in self.status.items()}
