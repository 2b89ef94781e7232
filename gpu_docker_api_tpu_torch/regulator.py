"""Per-chip concurrency regulator, the port's own copy of
gpu_docker_api_tpu/regulator.py (that module is not imported):
performance-isolated time-slicing of one card among co-located serving
loops.

The scheduler half of fractional grants says WHO may sit on a chip; this
module says WHEN. A serving batcher (workloads/serve.py) runs one device
dispatch per decode step, decode chunk or speculative round, so the chip
is a sequence of short exclusive device slices with host work between
them; interleaving the slices of N tenants turns one tenant's host gaps
into a co-tenant's throughput, and the chunk boundary is a bounded
preemption point (Tally, arXiv 2410.07381).

Mechanics per chip (ChipRegulator):

- each tenant registers with a WEIGHT (its share quanta from the grant)
  and a PRIORITY class ("latency" | "best_effort");
- a tenant wraps every device chunk in `with tenant.slice():`, and at
  most one tenant's chunk runs at a time;
- best-effort tenants share chip TIME by stride scheduling: a tenant's
  virtual time advances by chunk_seconds / weight, and the lowest virtual
  time runs next, so long-run chip time converges to the share ratio
  whatever each tenant's chunk sizes;
- a LATENCY-class tenant is admitted strictly first. One that arrives
  while a best-effort chunk is in flight flags that holder
  (`should_yield()`), counted as PREEMPTED: it finishes the chunk in
  flight (the bounded stall) and the latency tenant runs next; the
  yielding loop also drops back to single-step chunks while contended, so
  the stall bound tightens to one decode step.

The registry (`for_chip`) is process-global: serving loops in one OS
process that share a chip index share one regulator. Each chunk's time is
observed into metrics.REGULATOR_CHUNK; the daemon's /metrics exports every
chip's queue depth and preemption counters (snapshot()), and
`regulator.preempt` events land on its event log via set_events().
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

from . import metrics as obs_metrics

LATENCY = "latency"
BEST_EFFORT = "best_effort"
#: accepted spec values ("" defaults to best-effort)
PRIORITIES = ("", LATENCY, BEST_EFFORT)


class Tenant:
    """One tenant's handle on a chip's regulator. Thread-compatible: a
    tenant's slices are issued from its own serving loop thread; the
    handle itself is not meant to be shared across threads."""

    def __init__(self, reg: "ChipRegulator", name: str, weight: int,
                 priority: str):
        self.reg = reg
        self.name = name
        self.weight = max(int(weight), 1)
        self.priority = LATENCY if priority == LATENCY else BEST_EFFORT
        # stride-scheduling state (guarded by reg._cond)
        self.vt = 0.0                 # virtual chip time consumed
        self.waiting = False
        self.yield_flag = False
        self._t0 = 0.0
        self._seq = 0                 # registration order (stable ties)
        # telemetry
        self.chunks = 0
        self.tokens = 0
        self.busy_seconds = 0.0
        self.preempted = 0            # times flagged to yield
        self.wait_seconds = 0.0

    # -- the serving loop's surface ------------------------------------

    def acquire(self, timeout: Optional[float] = None) -> bool:
        return self.reg.acquire(self, timeout)

    def release(self, tokens: int = 0) -> None:
        self.reg.release(self, tokens)

    @contextlib.contextmanager
    def slice(self, tokens: int = 0):
        """Run one device chunk under the chip's admission control."""
        self.acquire()
        try:
            yield self
        finally:
            self.release(tokens)

    def should_yield(self) -> bool:
        """A latency-class tenant is waiting on this chip (or this
        holder was explicitly preempt-flagged): finish the chunk in
        flight, release, and keep chunks short while contended."""
        return self.reg.contended_for(self)

    def unregister(self) -> None:
        self.reg.unregister(self)


class ChipRegulator:
    """Admission control for one chip's decode chunks."""

    def __init__(self, chip: int = -1, events=None):
        self.chip = chip
        self.events = events
        self._cond = threading.Condition()
        # keyed by registration seq, NOT name: two tenants picking the
        # same name must both stay admittable (a silent dict replace
        # would strand the displaced tenant's acquire() forever)
        self._tenants: dict[int, Tenant] = {}
        self._holder: Optional[Tenant] = None
        self._global_vt = 0.0
        self._seq = 0
        # counters (/metrics)
        self.preempt_total = 0
        self.chunks_total = 0
        self.busy_seconds = 0.0

    # -- registration ---------------------------------------------------

    def register(self, name: str, weight: int = 1,
                 priority: str = BEST_EFFORT) -> Tenant:
        """Add a tenant. weight = its share quanta (a whole-chip tenant
        passes SHARE_QUANTA); chip time converges to the weight ratio
        among contending best-effort tenants. Names are labels for
        telemetry only — a duplicate name registers a SECOND tenant,
        never displaces the first."""
        with self._cond:
            t = Tenant(self, name, weight, priority)
            # join at the current virtual frontier: a newcomer must not
            # replay the chip time it was absent for
            t.vt = self._global_vt
            t._seq = self._seq
            self._seq += 1
            self._tenants[t._seq] = t
            return t

    def unregister(self, tenant: Tenant) -> None:
        with self._cond:
            self._tenants.pop(tenant._seq, None)
            if self._holder is tenant:
                self._holder = None
            tenant.waiting = False
            self._cond.notify_all()

    # -- admission ------------------------------------------------------

    def _pick(self) -> Optional[Tenant]:
        """Next admitted tenant among waiters: latency class strictly
        first, then lowest virtual time (stride scheduling), then
        registration order."""
        waiters = [t for t in self._tenants.values() if t.waiting]
        if not waiters:
            return None
        return min(waiters, key=lambda t: (t.priority != LATENCY,
                                           t.vt, t._seq))

    def acquire(self, tenant: Tenant, timeout: Optional[float] = None) -> bool:
        """Wait until `tenant` holds the chip: True; or, past `timeout`
        seconds, leave the contention set and answer False."""
        t_wait = time.perf_counter()
        with self._cond:
            # joining the contention set: catch up to the virtual
            # frontier so a tenant that idled (no traffic) cannot
            # monopolize the chip replaying its lag
            tenant.vt = max(tenant.vt, self._global_vt)
            tenant.waiting = True
            if (tenant.priority == LATENCY and self._holder is not None
                    and self._holder.priority != LATENCY
                    and not self._holder.yield_flag):
                # preempt: the best-effort holder yields at its chunk
                # boundary — bounded stall, counted and surfaced
                self._holder.yield_flag = True
                self._holder.preempted += 1
                self.preempt_total += 1
                if self.events is not None:
                    self.events.record(
                        "regulator.preempt", target=f"chip{self.chip}",
                        tenant=tenant.name, holder=self._holder.name)
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while self._holder is not None or self._pick() is not tenant:
                left = None
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        tenant.waiting = False
                        self._cond.notify_all()
                        return False
                self._cond.wait(left)
            tenant.waiting = False
            self._holder = tenant
            self._global_vt = max(self._global_vt, tenant.vt)
            tenant._t0 = time.perf_counter()
            tenant.wait_seconds += tenant._t0 - t_wait
            return True

    def release(self, tenant: Tenant, tokens: int = 0) -> None:
        with self._cond:
            if self._holder is not tenant:
                return
            dt = time.perf_counter() - tenant._t0
            tenant.vt += dt / tenant.weight
            tenant.busy_seconds += dt
            tenant.chunks += 1
            tenant.tokens += tokens
            tenant.yield_flag = False
            self.chunks_total += 1
            self.busy_seconds += dt
            self._holder = None
            self._cond.notify_all()
        # outside the condition: one histogram update per device chunk —
        # the distribution IS the preemption stall bound (a latency
        # tenant waits at most one chunk of the holder)
        obs_metrics.REGULATOR_CHUNK.observe(dt * 1e3)

    def contended_for(self, tenant: Tenant) -> bool:
        with self._cond:
            if tenant.yield_flag:
                return True
            if tenant.priority == LATENCY:
                return False
            return any(t.waiting and t.priority == LATENCY
                       for t in self._tenants.values())

    # -- telemetry ------------------------------------------------------

    def queue_depth(self) -> int:
        with self._cond:
            return sum(1 for t in self._tenants.values() if t.waiting)

    def describe(self) -> dict:
        with self._cond:
            return {
                "chip": self.chip,
                "tenants": [{
                    "name": t.name, "weight": t.weight,
                    "priority": t.priority, "chunks": t.chunks,
                    "tokens": t.tokens,
                    "busySeconds": round(t.busy_seconds, 6),
                    "waitSeconds": round(t.wait_seconds, 6),
                    "preempted": t.preempted,
                } for t in self._tenants.values()],
                "queueDepth": sum(1 for t in self._tenants.values()
                                  if t.waiting),
                "preemptTotal": self.preempt_total,
                "chunksTotal": self.chunks_total,
                "busySeconds": round(self.busy_seconds, 6),
            }


# ---- process-global registry ------------------------------------------------

_LOCK = threading.Lock()
_REGULATORS: dict[int, ChipRegulator] = {}
_EVENTS = None


def for_chip(chip: int) -> ChipRegulator:
    """The (process-wide) regulator for a chip index, created on first
    use. In-process serving loops sharing a chip share this instance."""
    with _LOCK:
        reg = _REGULATORS.get(chip)
        if reg is None:
            reg = _REGULATORS[chip] = ChipRegulator(chip, events=_EVENTS)
        return reg


def set_events(events) -> None:
    """Route regulator.preempt events onto the daemon's event log
    (existing and future regulators)."""
    global _EVENTS
    with _LOCK:
        _EVENTS = events
        for reg in _REGULATORS.values():
            reg.events = events


def snapshot() -> list[dict]:
    """describe() of every live regulator (the /metrics walk)."""
    with _LOCK:
        regs = list(_REGULATORS.values())
    return [r.describe() for r in regs]


def reset() -> None:
    """Drop all regulators (tests; a fresh App in the same process)."""
    with _LOCK:
        _REGULATORS.clear()


def tenant_from_env(default_name: str = "") -> Optional[Tenant]:
    """Build a tenant handle from the env the control plane injects into
    fractionally granted containers: weight from TDAPI_TPU_SHARES, class
    from TDAPI_PRIORITY, chip from the first CUDA_VISIBLE_DEVICES entry
    (what the card scheduler writes), or from the first TPU_VISIBLE_CHIPS
    entry when CUDA_VISIBLE_DEVICES is absent (the JAX daemon's grant). An
    entry that is no index (a GPU UUID) keys chip -1. None when the env
    says this workload owns its chips whole (no shares and no explicit
    priority). The tenant's label is `default_name`, or one made of the
    container's version and the pid."""
    import os
    shares = os.environ.get("TDAPI_TPU_SHARES", "")
    priority = os.environ.get("TDAPI_PRIORITY", "")
    if not shares and not priority:
        return None
    try:
        weight = max(int(shares or 0), 1)
    except ValueError:
        weight = 1
    chips = os.environ.get("CUDA_VISIBLE_DEVICES")
    if chips is None:
        chips = os.environ.get("TPU_VISIBLE_CHIPS", "")
    try:
        chip = int(chips.split(",")[0]) if chips else -1
    except ValueError:
        chip = -1
    # label only (register() never collides on names), but keep it
    # distinguishable across container versions and processes anyway
    name = default_name
    if not name:
        v = os.environ.get("CONTAINER_VERSION", "")
        name = f"tenant{'-v' + v if v else ''}-pid{os.getpid()}"
    return for_chip(chip).register(name, weight=weight,
                                   priority=priority or BEST_EFFORT)
