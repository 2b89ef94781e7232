"""Tail-tolerance POLICY for both router tiers.

The port's copy of the JAX control plane's tailtolerance.py, unchanged
(stdlib only): a gateway holds JAX and PyTorch replicas to the same math.

A binary failure model (READY until three transport strikes mark a
replica FAILED) lets a *gray* replica (slow-but-alive, the shape a
co-tenant's interference gives) keep absorbing its full least-queued
share and drag fleet p99. This module holds the policies that fix that,
deliberately separated
from any transport so the in-process `Gateway` (gateway.py) and the
SO_REUSEPORT `WorkerRouter` (server/workers.py) run the SAME math over
the same state:

- **LatencyDigest** — per-replica EWMA + windowed p95 estimate, folded
  at response time from the replica's SERVICE time (post-claim, so
  admission queueing never pollutes the signal). The digest round-trips
  through three int64 shm cells (count | ewma_us | p95_us) published
  under the roster segment's mini-seqlock cell groups, which is how the
  worker tier sees the gateway's signal (and vice versa) with zero
  daemon round-trips.
- **eject_set** — the outlier-ejection decision as a PURE function of
  `(key, p95_ms, count)` stats: replicas whose windowed p95 exceeds
  `k×` the fleet median go to PROBATION, capped at ≤50% of the fleet
  (counting replicas already ejected), worst-first. Both tiers call
  this one function over the same shm-published digests, so they make
  the same ejection decisions by construction.
- **ProbationTracker** — the in-process gateway's stateful half:
  ejected (and transport-strike FAILED) replicas are score-penalized,
  re-admitted only after N consecutive trickle probes pass. The worker
  tier is stateless per-request, so its probation is the recomputed
  eject set plus `trickle_allow`'s deterministic probe window.
- **HedgePolicy** — non-streaming requests slower than the fleet
  digest's hedge delay get a duplicate on a different replica; first
  completion wins, the loser releases its slot on completion. Hedges
  draw from a token bucket refilled per completed request (~5% added
  load cap).
- **RetryBudget** — transport-failure retries draw from a per-gateway
  token bucket refilled as a fraction of successes; exhaustion sheds
  503 + Retry-After instead of amplifying a brownout into a retry
  storm.

Kill switches (all default-on): TDAPI_GW_EJECT=0, TDAPI_GW_HEDGE=0,
TDAPI_GW_RETRY_BUDGET=0. Everything here is stdlib-only and import-
light: worker processes and the mock-model workload both import it.
"""

from __future__ import annotations

import os
import statistics
import threading
import time

from typing import Callable, Iterable, Optional

# ---- knobs ------------------------------------------------------------------

EJECT_ENV = "TDAPI_GW_EJECT"
HEDGE_ENV = "TDAPI_GW_HEDGE"
RETRY_BUDGET_ENV = "TDAPI_GW_RETRY_BUDGET"


def knob(name: str) -> bool:
    """Kill-switch env knob: on unless explicitly '0' (the same idiom
    as TDAPI_GW_AFFINITY)."""
    return os.environ.get(name, "1") != "0"


# ---- digest -----------------------------------------------------------------

#: EWMA smoothing for the mean service time
EWMA_ALPHA = 0.2
#: p95 estimator step, as a fraction of the EWMA (plus an absolute
#: floor so a 0ms-latency fleet still moves)
P95_STEP_FRAC = 0.05
P95_STEP_FLOOR_MS = 0.1


class LatencyDigest:
    """EWMA + windowed-quantile estimate of one replica's service time.

    The p95 is a stochastic-approximation (pinball-loss) estimator: a
    sample above the estimate pushes it up 19 steps, one below pulls it
    down 1 — the stationary point sits at the 95th percentile, and the
    step-per-sample update is what makes it *windowed*: the estimate
    tracks drift instead of averaging over all history. Cells are int64
    microseconds so the digest round-trips losslessly through the shm
    roster segment's mini-seqlock cell groups."""

    __slots__ = ("count", "ewma_ms", "p95_ms")

    def __init__(self, count: int = 0, ewma_ms: float = 0.0,
                 p95_ms: float = 0.0):
        self.count = count
        self.ewma_ms = ewma_ms
        self.p95_ms = p95_ms

    def observe(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        if self.count == 0:
            self.ewma_ms = ms
            self.p95_ms = ms
        else:
            self.ewma_ms += EWMA_ALPHA * (ms - self.ewma_ms)
            step = max(self.ewma_ms * P95_STEP_FRAC, P95_STEP_FLOOR_MS)
            if ms > self.p95_ms:
                self.p95_ms += 19.0 * step
            else:
                self.p95_ms = max(self.p95_ms - step, 0.0)
        self.count += 1

    def to_cells(self) -> tuple[int, int, int]:
        """(count, ewma_us, p95_us) — the shm cell encoding."""
        return (int(self.count), int(self.ewma_ms * 1000.0),
                int(self.p95_ms * 1000.0))

    @classmethod
    def from_cells(cls, cells) -> "LatencyDigest":
        """Rebuild from shm cells; None (torn read / never published)
        is an empty digest."""
        if not cells:
            return cls()
        count, ewma_us, p95_us = cells
        return cls(int(count), ewma_us / 1000.0, p95_us / 1000.0)


def fold_cells(cells, ms: float) -> tuple[int, int, int]:
    """One read-modify-publish step over the shm cell encoding: the
    worker tier's response-time fold (racing folders lose benignly —
    the cell publish is a CAS try-lock and a dropped sample is noise)."""
    d = LatencyDigest.from_cells(cells)
    d.observe(ms)
    return d.to_cells()


class LocalLatencyStore:
    """Per-replica digests keyed by roster row, for a gateway running
    without the worker tier (unit tests, mock substrate). The worker
    tier swaps in its shm-backed twin (server/workers.ShmLatencyStore)
    so both tiers fold into — and decide from — the same cells."""

    def __init__(self):
        self._d: dict[int, LatencyDigest] = {}

    def fold(self, row: int, ms: float) -> None:
        d = self._d.get(row)
        if d is None:
            d = self._d[row] = LatencyDigest()
        d.observe(ms)

    def snapshot(self) -> dict[int, tuple[int, float, float]]:
        """{row: (count, ewma_ms, p95_ms)} for rows with any samples."""
        return {row: (d.count, d.ewma_ms, d.p95_ms)
                for row, d in self._d.items() if d.count > 0}

    def reset(self, row: int) -> None:
        """Forget a row's history (probation re-admission: the replica
        re-learns fresh instead of flapping on its stale-high p95)."""
        self._d.pop(row, None)


# ---- ejection ---------------------------------------------------------------

#: eject when windowed p95 exceeds k × the fleet median p95
EJECT_K = 3.0
#: digest samples before a replica's p95 is trusted either way
EJECT_MIN_COUNT = 10
#: at most this fraction of the fleet in probation at once
EJECT_CAP = 0.5
#: absolute outlier floor: never eject below this p95 (ms) — a 0.2ms
#: fleet with one 0.8ms replica is noise, not gray failure
EJECT_FLOOR_MS = 5.0

#: additive score penalty composed ON TOP of kvaffinity.score for
#: probation replicas: large enough to dominate any queue-depth ×
#: W_QUEUE − hit_tokens spread, so a probation replica only wins a
#: pick when no healthy replica can take the request at all
#: (availability over purity), or when its trickle probe is due
PENALTY_SCORE = 1 << 20


def eject_set(stats: Iterable[tuple], *, k: float = EJECT_K,
              min_count: int = EJECT_MIN_COUNT, cap: float = EJECT_CAP,
              floor_ms: float = EJECT_FLOOR_MS,
              already: frozenset = frozenset(),
              fleet: Optional[int] = None) -> set:
    """The gray-failure ejection decision, pure over plain data so both
    router tiers (and the tests) share it verbatim.

    `stats` is [(key, p95_ms, count)] for the replicas under
    consideration; `already` holds keys currently in probation (their
    stale digests are excluded from the median AND they count against
    the cap); `fleet` is the ready-fleet size the cap is computed over
    (defaults to len(stats)). Returns the keys to eject, worst-first,
    bounded so probation never exceeds cap × fleet."""
    rows = [(key, float(p95), int(count)) for key, p95, count in stats
            if key not in already and int(count) >= min_count]
    if len(rows) < 2:
        return set()            # no fleet to be an outlier OF
    n = max(int(fleet) if fleet is not None else len(rows) + len(already),
            1)
    allowed = int(n * cap) - len(already)
    if allowed <= 0:
        return set()
    median = statistics.median(p95 for _, p95, _ in rows)
    threshold = max(k * median, floor_ms)
    out = sorted((row for row in rows if row[1] > threshold),
                 key=lambda row: -row[1])
    return {key for key, _, _ in out[:allowed]}


def fleet_median_p95(stats: Iterable[tuple],
                     already: frozenset = frozenset(),
                     min_count: int = EJECT_MIN_COUNT) -> Optional[float]:
    """The healthy fleet's median p95 (ms) — the probe pass/fail bar
    shares ejection's baseline."""
    vals = [float(p95) for key, p95, count in stats
            if key not in already and int(count) >= min_count]
    return statistics.median(vals) if vals else None


# ---- probation (stateful half: the in-process gateway) ----------------------

#: consecutive probe passes before re-admission
PROBE_PASSES = 3
#: min gap between trickle probes into one probation replica
PROBE_INTERVAL_S = 1.0


class _Probation:
    __slots__ = ("kind", "since", "passes", "last_probe")


class ProbationTracker:
    """Probation membership + trickle-probe state for one gateway.
    Callers (Gateway) hold their own condition around every call; the
    tracker itself is plain state. `now` is injectable for the
    state-machine unit tests."""

    def __init__(self, n_pass: int = PROBE_PASSES,
                 probe_interval_s: float = PROBE_INTERVAL_S,
                 now: Callable[[], float] = time.monotonic):
        self.n_pass = n_pass
        self.probe_interval_s = probe_interval_s
        self._now = now
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, key) -> bool:
        return key in self._entries

    def names(self) -> list:
        return sorted(self._entries)

    def kind(self, key) -> Optional[str]:
        e = self._entries.get(key)
        return e.kind if e is not None else None

    def eject(self, key, kind: str = "latency") -> bool:
        """Enter probation; False if already there. The first probe
        only comes due a full interval later — the replica just proved
        itself slow (or dead), re-probing it immediately would hand it
        another user request for nothing."""
        if key in self._entries:
            return False
        e = _Probation()
        e.kind = kind
        e.since = e.last_probe = self._now()
        e.passes = 0
        self._entries[key] = e
        return True

    def probe_due(self, key) -> bool:
        e = self._entries.get(key)
        return (e is not None
                and self._now() - e.last_probe >= self.probe_interval_s)

    def note_probe(self, key) -> None:
        e = self._entries.get(key)
        if e is not None:
            e.last_probe = self._now()

    def verdict(self, key, ok: bool) -> bool:
        """Fold one probe outcome. True = the replica just re-admitted
        (N consecutive passes — the entry is gone); a failure resets
        the consecutive count to zero."""
        e = self._entries.get(key)
        if e is None:
            return False
        if not ok:
            e.passes = 0
            return False
        e.passes += 1
        if e.passes >= self.n_pass:
            del self._entries[key]
            return True
        return False

    def drop(self, key) -> None:
        self._entries.pop(key, None)

    def prune(self, keep) -> None:
        """Drop entries whose replica left the eligible set (deleted,
        scale-downed, warm-readmitted elsewhere)."""
        for key in list(self._entries):
            if key not in keep:
                del self._entries[key]

    def describe(self) -> dict:
        return {str(key): {"kind": e.kind, "passes": e.passes}
                for key, e in self._entries.items()}


# ---- probation (stateless half: the worker tier) ----------------------------

#: worker-tier trickle probe: every `spacing`-th window of this length
#: one ejected row competes un-penalized (bounded probe traffic with no
#: per-replica state; every worker process computes the same window)
WORKER_PROBE_WINDOW_S = 0.25
WORKER_PROBE_SPACING = 16


def trickle_allow(rows, now: float,
                  window_s: float = WORKER_PROBE_WINDOW_S,
                  spacing: int = WORKER_PROBE_SPACING):
    """Which ejected row (sorted list) the stateless tier lets compete
    un-penalized this instant, or None. Deterministic in `now`, so
    every worker process opens the same probe window for the same row —
    the probe stays a trickle, not N workers' worth."""
    if not rows:
        return None
    w = int(now / window_s)
    if w % spacing:
        return None
    return rows[(w // spacing) % len(rows)]


# ---- hedging ----------------------------------------------------------------


class HedgePolicy:
    """Hedge-delay derivation + the added-load token bucket.

    The delay is FACTOR × the fleet's median per-replica p95 (a request
    slower than that is in the tail some OTHER replica would likely
    beat); with fewer than MIN_COUNT folded samples or a single-replica
    fleet there is no basis to hedge and delay_s returns None. The
    bucket refills RATE tokens per completed primary request, so
    dispatched hedges are capped at ~RATE of offered load."""

    FACTOR = 1.5
    MIN_DELAY_S = 0.002
    MAX_DELAY_S = 2.0
    MIN_COUNT = 16
    RATE = 0.05
    BURST = 4.0
    REFRESH_S = 0.25

    def __init__(self, rate: float = RATE, burst: float = BURST,
                 now: Callable[[], float] = time.monotonic):
        self.rate = rate
        self.burst = burst
        self._now = now
        self._lock = threading.Lock()
        self.tokens = burst
        self._delay: Optional[float] = None
        self._delay_at = -1e18

    # bucket ------------------------------------------------------------

    def peek(self) -> bool:
        return self.tokens >= 1.0        # racy read: take() re-checks

    def take(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False

    def put_back(self) -> None:
        with self._lock:
            self.tokens = min(self.burst, self.tokens + 1.0)

    def feed(self) -> None:
        """One completed primary request: the ~5%-of-load refill."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + self.rate)

    # delay -------------------------------------------------------------

    def delay_s(self, snapshot_fn: Callable[[], dict]) -> Optional[float]:
        """Current hedge delay in seconds, or None (don't hedge).
        `snapshot_fn` yields {row: (count, ewma_ms, p95_ms)}; the
        derivation is cached for REFRESH_S so the per-request cost is
        one lock + two loads."""
        now = self._now()
        with self._lock:
            if now - self._delay_at < self.REFRESH_S:
                return self._delay
            self._delay_at = now
        snap = snapshot_fn()
        delay = None
        if snap and len(snap) >= 2:
            total = sum(c for c, _, _ in snap.values())
            if total >= self.MIN_COUNT:
                med = statistics.median(p for _, _, p in snap.values())
                delay = min(max(med * self.FACTOR / 1e3,
                                self.MIN_DELAY_S), self.MAX_DELAY_S)
        with self._lock:
            self._delay = delay
        return delay


# ---- retry budget -----------------------------------------------------------


class RetryBudget:
    """Per-gateway retry token bucket: the first attempt is free, every
    RETRY after a transport failure spends a token, and successes
    refill REFILL of one. A brownout that exhausts the budget sheds
    503 + Retry-After instead of multiplying its own load — retries
    amplify at most (1 + REFILL)× in steady state."""

    CAPACITY = 16.0
    REFILL = 0.1

    def __init__(self, capacity: float = CAPACITY,
                 refill: float = REFILL):
        self.capacity = float(capacity)
        self.refill = float(refill)
        self._lock = threading.Lock()
        self.tokens = self.capacity

    def success(self) -> None:
        with self._lock:
            self.tokens = min(self.capacity, self.tokens + self.refill)

    def try_retry(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False
