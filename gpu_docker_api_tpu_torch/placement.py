"""Heterogeneity-aware placement: fleet model + pluggable scoring objectives.

The port's copy of the JAX control plane's placement.py, over the card
scheduler (GpuScheduler): a pool is one generation's line of cards.

The mechanism layer (schedulers/gpu.py) answers "give me n cards" with
first-fit-by-compactness on ONE topology. On a mixed-generation fleet that
leaves integer factors on the table (Gavel, arXiv:2008.09213): a faster
card is worth several of an older one for a compute-bound trainer but
barely more for an input-bound job, so WHERE a workload lands is worth
more than any queueing tweak. This module adds the policy layer:

- ``FleetModel``: named pools (one ``GpuScheduler`` per generation slice)
  with per-workload throughput profiles: declared on
  ``ContainerRun.profile``, fitted from observed step times, or defaulted
  from the generation baselines in ``topology.GENERATION_SPECS``.
- ``Candidate`` enumeration: every plan-compatible fully-free box across
  every pool (scheduler ``enumerate_candidates``), not just first-fit's
  pick.
- Objectives: PURE functions ``(FleetSnapshot, Candidate, ctx) -> score``
  with no side effects and no scheduler access, so a simulator can replay
  them against synthetic snapshots and tests can assert their algebra
  directly. ``FleetModel.place`` is the only thing that touches a
  scheduler, and it commits the scored winner verbatim via ``claim()``.

The defragmenter (defrag.py) sits on the same read surface: it watches
``capacity_view`` for gangs that are geometry-feasible but
fragmentation-blocked and opens a contiguous box by migrating small
tenants away.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from . import xerrors
from .meshplan import PlanSpec
from .schedulers.gpu import GpuScheduler
from .topology import generation_spec

# fitted profiles keep a bounded window per (workload, generation): enough
# to average out warmup jitter, small enough that a long-running tenant
# tracks drift (recompiles, input-bound phases)
FIT_WINDOW = 64


@dataclass(frozen=True)
class Candidate:
    """One placeable box: a pool plus the geometry facts objectives may
    score on. Frozen — candidates are snapshot data, not live handles."""
    pool: str
    generation: str
    chips: tuple[int, ...]
    dims: tuple[int, ...]
    span: int            # hosts (nodes) the box spans
    surface: int         # box surface area (compactness)
    ext_free: int        # free links leaving the box (fragmentation damage)
    host_splits: int     # plan inner chunks crossing a host boundary


@dataclass(frozen=True)
class PoolView:
    """One pool's capacity at snapshot time (scheduler capacity_view)."""
    name: str
    generation: str
    accelerator_type: str
    total_chips: int
    free_chips: int
    free_quanta: int
    cordoned: int
    share_split: int
    largest_free_box: int
    fragmentation: float


@dataclass(frozen=True)
class FleetSnapshot:
    """Consistent-enough fleet view objectives score against. Per-pool
    views are individually locked snapshots; cross-pool skew is tolerable
    because claim() re-validates the winner's chips atomically."""
    pools: tuple[PoolView, ...]

    def pool(self, name: str) -> Optional[PoolView]:
        for p in self.pools:
            if p.name == name:
                return p
        return None


# ctx passed to every objective: {"profile": {generation: rel_throughput},
# "n": chips requested}. Objectives return a score (higher wins); ties
# break deterministically on (pool name, chips) in place().
Objective = Callable[[FleetSnapshot, Candidate, dict], float]

# packing epsilons: orders of magnitude below any real throughput delta,
# so they only order candidates the profile considers equivalent —
# prefer the box that frags the pool least, then the compactest
_EPS_EXT = 1e-3
_EPS_SURF = 1e-5
_EPS_SPLIT = 1e-4


def _thr(cand: Candidate, ctx: dict) -> float:
    prof = ctx.get("profile") or {}
    return float(prof.get(
        cand.generation,
        generation_spec(cand.generation)["rel_throughput"]))


def _packing_penalty(cand: Candidate) -> float:
    return (_EPS_EXT * cand.ext_free + _EPS_SURF * cand.surface
            + _EPS_SPLIT * (cand.host_splits + cand.span - 1))


def obj_max_throughput(snap: FleetSnapshot, cand: Candidate,
                       ctx: dict) -> float:
    """Fleet goodput: land each workload on the generation where ITS
    profile says a chip-step is worth most, packing as the tiebreak."""
    return _thr(cand, ctx) - _packing_penalty(cand)


def obj_finish_time_fairness(snap: FleetSnapshot, cand: Candidate,
                             ctx: dict) -> float:
    """Throughput discounted by how much of the pool's remaining headroom
    the grant consumes — the cheap proxy for Gavel's finish-time-fairness
    objective: a fast pool that is nearly full is NOT a fair place to
    land, because everyone queued behind pays the wait."""
    pool = snap.pool(cand.pool)
    n = int(ctx.get("n") or len(cand.chips))
    if pool is None or pool.free_chips <= 0:
        return -_packing_penalty(cand)
    headroom = max(0, pool.free_chips - n) / max(1, pool.total_chips)
    return _thr(cand, ctx) * (0.25 + headroom) - _packing_penalty(cand)


def obj_cost(snap: FleetSnapshot, cand: Candidate, ctx: dict) -> float:
    """Throughput per unit cost — prefers the cheapest generation that
    still moves this workload (a cheaper generation for anything whose
    profile does not collapse there)."""
    rel_cost = float(generation_spec(cand.generation)["rel_cost"]) or 1.0
    return _thr(cand, ctx) / rel_cost - _packing_penalty(cand)


def obj_first_fit(snap: FleetSnapshot, cand: Candidate, ctx: dict) -> float:
    """Score-free baseline: every candidate ties, so the deterministic
    tiebreak (pool name, lowest chips) reproduces naive first-fit. Exists
    so the bench's policy-vs-first-fit comparison runs both sides through
    the identical enumerate→score→claim pipeline."""
    return 0.0


POLICIES: dict[str, Objective] = {
    "max_throughput": obj_max_throughput,
    "finish_time_fairness": obj_finish_time_fairness,
    "cost": obj_cost,
    "first_fit": obj_first_fit,
}
DEFAULT_POLICY = "max_throughput"


class FleetModel:
    """Named scheduler pools + workload throughput profiles + one active
    objective. Pure-read everywhere except ``place`` (claims the scored
    winner) and the profile ledgers."""

    def __init__(self, pools: dict[str, GpuScheduler],
                 policy: str = DEFAULT_POLICY, events=None):
        if not pools:
            raise ValueError("fleet needs at least one pool")
        if policy not in POLICIES:
            raise ValueError(f"unknown placement policy {policy!r}; "
                             f"known: {sorted(POLICIES)}")
        self.pools = dict(pools)
        self.policy = policy
        self.events = events
        self._lock = threading.Lock()
        # declared profiles by workload name (ContainerRun.profile)
        self._declared: dict[str, dict[str, float]] = {}
        # fitted observations: name -> generation -> bounded step-ms window
        self._fitted: dict[str, dict[str, list[float]]] = {}
        self.scored_total = 0
        self.placements_total = 0

    # ---- profiles ----

    def declare_profile(self, name: str,
                        profile: Optional[dict]) -> None:
        with self._lock:
            if profile:
                self._declared[name] = {str(g): float(v)
                                        for g, v in profile.items()}
            else:
                self._declared.pop(name, None)

    def observe_step_time(self, name: str, generation: str,
                          step_ms: float) -> None:
        """Feed one observed training-step latency for `name` running on
        `generation` — the fit path when nothing was declared. Windowed;
        cross-generation ratios only become meaningful once ≥2
        generations have observations (see profile_for)."""
        if step_ms <= 0:
            return
        with self._lock:
            window = self._fitted.setdefault(name, {}).setdefault(
                generation, [])
            window.append(float(step_ms))
            if len(window) > FIT_WINDOW:
                del window[:len(window) - FIT_WINDOW]

    def profile_for(self, name: str,
                    declared: Optional[dict] = None) -> dict[str, float]:
        """Merged throughput profile: generation baselines <- fitted
        observations <- declared values (most specific wins).

        Fitted rates are only trusted for CROSS-generation ratios: a
        single-generation observation says nothing about how the workload
        would scale elsewhere, so it never perturbs the baseline. With
        observations on ≥2 generations, observed steps/s are re-anchored
        into the baseline frame at the most-sampled generation."""
        with self._lock:
            prof = {g: float(generation_spec(g)["rel_throughput"])
                    for g in {s.topology.generation
                              for s in self.pools.values()}}
            fit = self._fitted.get(name) or {}
            rates = {g: len(w) / (sum(w) / 1000.0)
                     for g, w in fit.items() if w and sum(w) > 0}
            if len(rates) >= 2:
                anchor = max(rates, key=lambda g: (len(fit[g]), g))
                base = prof.get(
                    anchor,
                    float(generation_spec(anchor)["rel_throughput"]))
                for g, r in rates.items():
                    prof[g] = base * (r / rates[anchor])
            for src in (self._declared.get(name), declared):
                if src:
                    prof.update({str(g): float(v) for g, v in src.items()})
            return prof

    # ---- read surface ----

    def snapshot(self) -> FleetSnapshot:
        views = []
        for pname in sorted(self.pools):
            cv = self.pools[pname].capacity_view()
            views.append(PoolView(
                name=pname,
                generation=cv["generation"],
                accelerator_type=cv["acceleratorType"],
                total_chips=cv["totalChips"],
                free_chips=cv["freeChips"],
                free_quanta=cv["freeQuanta"],
                cordoned=cv["cordoned"],
                share_split=cv["shareSplit"],
                largest_free_box=cv["largestFreeBox"],
                fragmentation=cv["fragmentation"],
            ))
        return FleetSnapshot(pools=tuple(views))

    def candidates_for(self, n: int,
                       plan: Optional[PlanSpec] = None) -> list[Candidate]:
        out = []
        for pname in sorted(self.pools):
            sched = self.pools[pname]
            gen = sched.topology.generation
            for c in sched.enumerate_candidates(n, plan=plan):
                out.append(Candidate(
                    pool=pname, generation=gen,
                    chips=tuple(c["chips"]), dims=tuple(c["dims"]),
                    span=c["span"], surface=c["surface"],
                    ext_free=c["extFree"], host_splits=c["hostSplits"]))
        return out

    # ---- the one mutating path ----

    def place(self, n: int, owner: str,
              plan: Optional[PlanSpec] = None,
              profile: Optional[dict] = None,
              policy: Optional[str] = None) -> tuple[str, list[int]]:
        """Score every candidate box fleet-wide under the active objective
        and claim the winner. Returns (pool name, granted chips). A claim
        lost to a concurrent grant re-scores against fresh candidates
        (bounded retries) — scoring is lock-free across pools, only the
        commit is atomic. Raises GpuNotEnoughError when no pool has a
        placeable box."""
        obj = POLICIES[policy or self.policy]
        ctx = {"profile": self.profile_for(owner, declared=profile), "n": n}
        last_err: Optional[Exception] = None
        for _ in range(3):
            cands = self.candidates_for(n, plan=plan)
            if not cands:
                break
            snap = self.snapshot()
            with self._lock:
                self.scored_total += len(cands)
            # max score; deterministic tiebreak on (pool, chips) so equal
            # scores place identically run-to-run
            best = min(cands, key=lambda c: (-obj(snap, c, ctx),
                                             c.pool, c.chips))
            try:
                chips = self.pools[best.pool].claim(
                    list(best.chips), owner, plan=plan)
            except xerrors.GpuNotEnoughError as e:
                last_err = e          # raced; enumerate again
                continue
            with self._lock:
                self.placements_total += 1
            if self.events is not None:
                self.events.record(
                    "placement.place", target=owner,
                    pool=best.pool, generation=best.generation,
                    chips=chips, policy=policy or self.policy,
                    score=round(obj(snap, best, ctx), 6))
            return best.pool, chips
        if last_err is not None:
            raise last_err
        raise xerrors.GpuNotEnoughError(
            f"no pool has a free contiguous box for {n} cards"
            + (f" shaped {plan.to_json()}" if plan is not None
               and not plan.is_trivial else ""))

    # ---- status ----

    def describe(self) -> dict:
        """GET /api/v1/placement payload: policy, per-pool capacity, the
        profile ledger sizes, and the placement counters."""
        snap = self.snapshot()
        with self._lock:
            return {
                "policy": self.policy,
                "policies": sorted(POLICIES),
                "pools": [{
                    "name": p.name,
                    "generation": p.generation,
                    "acceleratorType": p.accelerator_type,
                    "totalChips": p.total_chips,
                    "freeChips": p.free_chips,
                    "freeQuanta": p.free_quanta,
                    "cordoned": p.cordoned,
                    "shareSplit": p.share_split,
                    "largestFreeBox": p.largest_free_box,
                    "fragmentation": p.fragmentation,
                } for p in snap.pools],
                "declaredProfiles": sorted(self._declared),
                "fittedProfiles": sorted(self._fitted),
                "scoredTotal": self.scored_total,
                "placementsTotal": self.placements_total,
            }
