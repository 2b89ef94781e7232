"""GuardedBackend: deadlines + retries + circuit breaker around any Backend.

The port's copy of the JAX control plane's backend/guard.py, unchanged.

The reference talks to dockerd with library defaults: one hung Engine API
call parks a gin handler forever, and a flaky socket turns every request
into a raw 500 (SURVEY §5). Production accelerator fleets treat
substrate failure as routine — work is rescheduled around bad capacity,
not crashed into it (PAPERS.md: arxiv 2109.11067, 2008.09213). This decorator is the
control-plane half of that posture; the scheduler half is cordon/drain
(schedulers/gpu.py) fed by the health monitor.

Every Backend op is wrapped with, in order:

1. **circuit breaker admission** — after `breaker_threshold` consecutive
   op failures the breaker OPENS and calls fail fast with
   xerrors.BackendUnavailableError for `breaker_cooldown` seconds. Routes
   map it to HTTP 503 + Retry-After; reads degrade to the MVCC store
   (services fall back to stored records). After the cooldown ONE trial
   call is admitted (HALF-OPEN); success closes the breaker, failure
   re-opens it. Transitions emit events and ride /metrics gauges.
2. **per-op deadline** — the call runs on a worker thread and is abandoned
   past its deadline (BackendTimeoutError, transient). A stalled dockerd
   or a hung quota mount can no longer park a request thread forever.
3. **bounded retries** — transient errors (OSError family: sockets,
   vanished devices, injected faults; plus deadline overruns) retry with
   exponential backoff + full jitter. Non-transient errors ("container
   exists", bad input) propagate immediately and never trip the breaker.
   Exception: a deadline overrun on a NON_IDEMPOTENT op (create, commit,
   volume_create) is not retried — the abandoned attempt may yet
   complete, and re-issuing could double-apply; the caller's unwind (and
   ultimately the reconciler's orphan sweep) owns that outcome.

Fault injection (faults.fault_gate) is crossed INSIDE the deadline wrapper
so an injected hang is cut exactly like a real stall.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from .. import faults, xerrors
from ..analysis import lockwatch
from ..dtos import ContainerSpec
from ..obs import metrics as obs_metrics
from ..obs import trace
from .base import Backend, ContainerState, VolumeState

log = logging.getLogger(__name__)

#: transient = worth retrying and counted by the breaker. OSError covers
#: ConnectionError/TimeoutError subclasses, vanished devices, and
#: faults.InjectedFault; BackendTimeoutError is the guard's own deadline.
TRANSIENT = (OSError, xerrors.BackendTimeoutError)

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker shared by every op of one backend: the
    substrate is one dockerd / one host, so failures anywhere count
    against the same budget."""

    def __init__(self, threshold: int = 5, cooldown: float = 15.0,
                 events=None):
        self.threshold = max(1, int(threshold))
        self.cooldown = cooldown
        self.events = events
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive post-retry failures
        self._opened_at = 0.0
        self._trial_inflight = False

    # ---- admission / outcome ----

    def admit(self) -> bool:
        """Gate one call. Returns True when the call is the HALF-OPEN
        trial; raises BackendUnavailableError when the breaker refuses."""
        with self._lock:
            if self._state == CLOSED:
                return False
            now = time.monotonic()
            if self._state == OPEN:
                remaining = self._opened_at + self.cooldown - now
                if remaining > 0:
                    raise xerrors.BackendUnavailableError(
                        f"circuit open, retry in {remaining:.1f}s",
                        retry_after=max(1.0, remaining))
                self._transition(HALF_OPEN)
            # HALF_OPEN: exactly one trial at a time; everyone else waits
            if self._trial_inflight:
                raise xerrors.BackendUnavailableError(
                    "circuit half-open, trial call in flight",
                    retry_after=max(1.0, self.cooldown / 2))
            self._trial_inflight = True
            return True

    def record_success(self, trial: bool) -> None:
        with self._lock:
            self._failures = 0
            if trial:
                self._trial_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self, trial: bool) -> None:
        with self._lock:
            self._failures += 1
            if trial:
                self._trial_inflight = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.threshold):
                self._opened_at = time.monotonic()
                self._transition(OPEN)

    # ---- admin / introspection ----

    def force_open(self, cooldown: Optional[float] = None) -> None:
        """Operator/test override: trip the breaker now."""
        with self._lock:
            if cooldown is not None:
                self.cooldown = cooldown
            self._opened_at = time.monotonic()
            self._trial_inflight = False
            if self._state != OPEN:
                self._transition(OPEN)

    def force_close(self) -> None:
        with self._lock:
            self._failures = 0
            self._trial_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    @property
    def state(self) -> str:
        with self._lock:
            # surface the pending half-open so /healthz shows "probing"
            if (self._state == OPEN
                    and time.monotonic() >= self._opened_at + self.cooldown):
                return HALF_OPEN
            return self._state

    def describe(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutiveFailures": self._failures,
                "threshold": self.threshold,
                "cooldownSec": self.cooldown,
            }

    def _transition(self, to: str) -> None:
        """Lock held. Event emission is best-effort and must not throw
        into the op path."""
        frm, self._state = self._state, to
        log.warning("backend circuit breaker: %s -> %s (failures=%d)",
                    frm, to, self._failures)
        if self.events is not None:
            try:
                self.events.record(f"breaker.{to}", code=200,
                                   previous=frm, failures=self._failures)
            except Exception:  # noqa: BLE001
                log.exception("recording breaker transition")


def _call_with_deadline(fn: Callable, deadline: float, op: str):
    """Run fn on a worker thread, abandoning it past the deadline. The
    overrun thread is left to finish/die on its own — exactly the
    semantics of a timed-out RPC whose server may still be chewing."""
    if deadline is None or deadline <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — ferried to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name=f"backend-op-{op}")
    t.start()
    if not done.wait(deadline):
        raise xerrors.BackendTimeoutError(f"{op} overran {deadline:.1f}s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


#: ops that create named state on the substrate: re-issuing one whose
#: first attempt TIMED OUT (outcome unknown — the abandoned thread may
#: still complete it) could double-apply, so deadline overruns on these
#: fail fast to the caller's unwind instead of retrying. A transient
#: ERROR is different: the substrate answered "no", nothing happened.
NON_IDEMPOTENT = frozenset({"create", "commit", "volume_create"})

#: best-effort ops: never retried. A quiesce retry would be DESTRUCTIVE —
#: its stale-ack unlink deletes the ack a workload that already parked
#: wrote, and re-signaling a parked workload can never produce a new one —
#: and the caller's contract already degrades cleanly (fall back to the
#: plain stop), so one attempt is the whole budget.
BEST_EFFORT = frozenset({"quiesce"})


class GuardedBackend(Backend):
    """Decorator implementing every Backend method through the guard."""

    def __init__(self, inner: Backend,
                 deadline: float = 30.0,
                 deadlines: Optional[dict[str, float]] = None,
                 retries: int = 2,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 2.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 15.0,
                 events=None):
        self.inner = inner
        self.deadline = deadline
        self.deadlines = dict(deadlines or {})
        self.retries = max(0, int(retries))
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown,
                                      events=events)

    # substrate exclusivity is the INNER backend's property (reconciler
    # orphan sweeps consult it)
    @property
    def exclusive_substrate(self) -> bool:  # type: ignore[override]
        return self.inner.exclusive_substrate

    def __getattr__(self, name: str):
        # non-contract surface (volume_tiers, test helpers) passes through
        # to the inner backend. Attributes the Backend base CLASS defines
        # never reach __getattr__ — those need explicit overrides (the
        # health hooks below).
        return getattr(self.inner, name)

    # health hooks delegate UNGUARDED on purpose: probing must keep seeing
    # the substrate while the breaker refuses workload ops, and a probe's
    # own failure is its signal, not breaker fuel. Explicit overrides
    # because the inherited base-class defaults (always-healthy) would
    # shadow __getattr__ delegation.

    def ping(self) -> bool:
        return self.inner.ping()

    def chip_available(self, device_path: str) -> bool:
        return self.inner.chip_available(device_path)

    def flap_counts(self) -> dict[str, int]:
        return self.inner.flap_counts()

    # volume_tiers is assigned by make_backend/App post-construction; land
    # it on the inner backend, which is what reads it
    def __setattr__(self, name: str, value) -> None:
        if name == "volume_tiers" and "inner" in self.__dict__:
            setattr(self.inner, name, value)
            return
        object.__setattr__(self, name, value)

    # ---- the guard ----

    def _guard(self, op: str, fn: Callable,
               deadline: Optional[float] = None):
        # lockwatch seam: flag watched locks the CALLING thread holds at
        # op entry (the deadline worker thread below holds nothing). Fast
        # no-op unless TDAPI_LOCKWATCH armed a watcher.
        lockwatch.note_backend_op(op)
        with trace.span(f"backend.{op}") as sp:
            try:
                trial = self.breaker.admit()
            except xerrors.BackendUnavailableError as e:
                # breaker refusal: visible as a span event, not a timed
                # child — no substrate call happened, so it must not feed
                # the op-latency histogram either (thousands of ~0ms
                # rejections during an outage would drag the percentiles
                # toward zero exactly when they matter)
                if sp is not None:
                    sp.event("breaker.rejected", state=self.breaker.state,
                             retryAfter=round(
                                 getattr(e, "retry_after", 0.0), 1))
                raise
            t0 = time.perf_counter()
            try:
                return self._guarded(op, fn, deadline, trial, sp)
            finally:
                obs_metrics.BACKEND_OP_LATENCY.observe(
                    (time.perf_counter() - t0) * 1e3, op=op)

    def _guarded(self, op: str, fn: Callable, deadline: Optional[float],
                 trial, sp) -> object:
        if deadline is None:
            deadline = self.deadlines.get(op, self.deadline)
        attempt = 0

        def one_attempt():
            faults.fault_gate(op)
            return fn()

        while True:
            try:
                result = _call_with_deadline(one_attempt, deadline, op)
            except TRANSIENT as e:
                retryable = (op not in BEST_EFFORT
                             and not (isinstance(e, xerrors.BackendTimeoutError)
                                      and op in NON_IDEMPOTENT))
                if retryable and attempt < self.retries:
                    attempt += 1
                    # full jitter: decorrelates a thundering herd of
                    # retries against a recovering dockerd
                    delay = random.uniform(
                        0, min(self.backoff_cap,
                               self.backoff_base * (2 ** (attempt - 1))))
                    log.debug("backend %s transient (%s) — retry %d/%d "
                              "in %.3fs", op, e, attempt, self.retries,
                              delay)
                    if sp is not None:
                        sp.event("retry", attempt=attempt,
                                 error=type(e).__name__,
                                 backoffMs=round(delay * 1e3, 1))
                    time.sleep(delay)
                    continue
                self.breaker.record_failure(trial)
                if sp is not None:
                    sp.event("failed", attempts=attempt + 1,
                             error=type(e).__name__)
                raise
            except Exception:
                # semantic error: the substrate answered, just not the
                # way the caller hoped — neither retried nor breaker fuel
                self.breaker.record_success(trial)
                raise
            self.breaker.record_success(trial)
            return result

    # ---- containers ----

    def create(self, name: str, spec: ContainerSpec) -> str:
        return self._guard("create", lambda: self.inner.create(name, spec))

    def start(self, name: str) -> None:
        return self._guard("start", lambda: self.inner.start(name))

    def stop(self, name: str, timeout: float = 10.0) -> None:
        return self._guard("stop", lambda: self.inner.stop(name, timeout))

    def pause(self, name: str) -> None:
        return self._guard("pause", lambda: self.inner.pause(name))

    def quiesce(self, name: str, timeout: float = 30.0) -> bool:
        # a quiesce legitimately blocks up to its OWN timeout waiting for
        # the workload's checkpoint ack, so the generic per-op deadline
        # must not cut a healthy wait short — unless the operator pinned
        # an explicit "quiesce" deadline, grant the call its timeout plus
        # signaling slack. Single attempt (BEST_EFFORT): a retry's
        # stale-ack unlink would destroy a parked workload's legitimate
        # ack, and the caller falls back to the plain stop anyway.
        dl = self.deadlines.get("quiesce",
                                max(self.deadline, timeout + 5.0))
        return self._guard("quiesce",
                           lambda: self.inner.quiesce(name, timeout),
                           deadline=dl)

    def restart_inplace(self, name: str) -> None:
        return self._guard("restart_inplace",
                           lambda: self.inner.restart_inplace(name))

    def remove(self, name: str, force: bool = False) -> None:
        return self._guard("remove", lambda: self.inner.remove(name, force))

    def execute(self, name: str, cmd: list[str],
                workdir: str = "") -> tuple[int, str]:
        return self._guard("execute",
                           lambda: self.inner.execute(name, cmd, workdir))

    def inspect(self, name: str) -> ContainerState:
        return self._guard("inspect", lambda: self.inner.inspect(name))

    def commit(self, name: str, new_image: str) -> str:
        return self._guard("commit",
                           lambda: self.inner.commit(name, new_image))

    def list_names(self, prefix: str = "") -> list[str]:
        return self._guard("list_names",
                           lambda: self.inner.list_names(prefix))

    # ---- volumes ----

    def volume_create(self, name: str, size_bytes: int = 0,
                      tier: str = "") -> VolumeState:
        return self._guard(
            "volume_create",
            lambda: self.inner.volume_create(name, size_bytes, tier))

    def volume_remove(self, name: str) -> None:
        return self._guard("volume_remove",
                           lambda: self.inner.volume_remove(name))

    def volume_inspect(self, name: str) -> VolumeState:
        return self._guard("volume_inspect",
                           lambda: self.inner.volume_inspect(name))

    def volume_list(self) -> list[str]:
        return self._guard("volume_list", lambda: self.inner.volume_list())

    # ---- lifecycle ----

    def close(self) -> None:
        # shutdown must not be refused by an open breaker
        self.inner.close()


def breaker_gauge(state: str) -> int:
    """Numeric encoding for /metrics: 0 closed, 1 half-open, 2 open."""
    return _STATE_GAUGE.get(state, 0)
