"""Card scheduler of an NVIDIA node: the port's TpuScheduler.

The JAX control plane's schedulers/tpu.py over a GpuTopology (topology.py):
the same apply/restore/claim/persist surface, the same share ledger, the
same cordon set and the same stored state. On the node's line of cards
`(n, 1, 1)` it grants exactly what TpuScheduler grants on a TpuTopology of
that shape:

1. an exact run of N linked cards when one is free, choosing among free
   runs the most packed placement (fewest free neighbours outside it) to
   fight fragmentation;
2. else a connected free set of N cards (BFS over links) minimizing its
   bounding box;
3. else — only when allow_fragmented — any N free cards, like the
   reference.

The box search is the Python one. With `native_finder=True` JAX's C++
finder (native/topology_alloc.cc, built by _native.py) searches first, as
JAX's scheduler does whenever its core loads, and the Python search stays
the fallback when the core cannot load.
The state persists under JAX's key (`tpus/tpuStatusMap`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from .. import xerrors
from ..meshplan import PlanSpec
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..store.client import ResourcePrefix, StateClient
from ..topology import (
    Chip, GpuTopology, discover_topology, plan_fits_box,
)
from ..workqueue import WorkQueue
from .base import FREE, Scheduler, _norm_owner, merge_stored_status

# Fractional-grant quantum: one chip divides into SHARE_QUANTA equal
# shares (0.25 chip each). A fractional replicaSet holds 1-3 quanta of
# exactly ONE chip; the per-chip ledger sums to at most SHARE_QUANTA, so
# a chip can never be oversubscribed (Tally / ParvaGPU: sharing with a
# hard capacity invariant, time-multiplexed by the serving-path
# regulator — regulator.py).
SHARE_QUANTA = 4


def parse_gpu_count(count) -> tuple[int, int]:
    """Split a request's card count into (whole_cards, share_quanta).

    Whole counts (1, 2, 4.0, ...) return (n, 0). Fractional counts are a
    share of ONE chip and must be a multiple of 1/SHARE_QUANTA below 1
    (0.25, 0.5, 0.75) -> (0, quanta). Anything else — negative, 1.5,
    0.3 — raises ValueError with a client-facing message."""
    c = float(count)
    if c < 0:
        raise ValueError("tpuCount must be >= 0")
    if c == int(c):
        return int(c), 0
    q = c * SHARE_QUANTA
    if abs(q - round(q)) > 1e-9 or c > 1:
        raise ValueError(
            f"fractional tpuCount must be a multiple of "
            f"{1 / SHARE_QUANTA} below 1 (a share of one chip); got {count}")
    return 0, int(round(q))


class GpuScheduler(Scheduler):
    # JAX's key space, so either package's daemon reboots from the other's
    resource = ResourcePrefix.Tpus
    state_key = "tpuStatusMap"

    def __init__(self, client: Optional[StateClient] = None,
                 wq: Optional[WorkQueue] = None,
                 topology: Optional[GpuTopology] = None,
                 allow_fragmented: bool = True,
                 native_finder: bool = False):
        super().__init__(client, wq)
        # the C++ box search (native/topology_alloc.cc) in front of the
        # Python one, as JAX's scheduler takes it whenever its core loads;
        # opt-in here (see _find_box)
        self.native_finder = native_finder
        self.allow_fragmented = allow_fragmented
        # per-n memo of candidate boxes: the topology's geometry never
        # changes after construction, so enumerating sub_boxes + computing
        # indices/exterior-links/worker-span per candidate on EVERY apply
        # was pure hot-path waste (profiled at ~15ms per 4-chip grant on a
        # 32-chip mesh); the cached walk is set-membership only
        self._box_cache: dict[int, list[tuple]] = {}
        state = self._load_state()
        if state is not None and topology is None:
            self.topology = _stored_topology(state["topology"])
            self.status = {int(k): _norm_owner(v)
                           for k, v in state["status"].items()}
        else:
            self.topology = topology or discover_topology()
            # explicit topology overrides the stored one; stored chip states
            # carry over where indices still exist
            self.status = merge_stored_status(
                state["status"] if state is not None else None,
                {c.index: FREE for c in self.topology.chips})
        # cordoned set: chips excluded from every placement (health monitor
        # or operator marked them bad). Persisted with the status map so a
        # restart cannot resurrect a dead chip as allocatable; indices that
        # no longer exist under an overriding topology are dropped.
        self.cordoned: set[int] = {
            int(i) for i in (state.get("cordoned", [])
                             if state is not None else [])
            if int(i) in self.status}
        # fractional-share ledger: chip index -> {owner: quanta}. Chips
        # with any entry here are invisible to whole-chip placement, and
        # the per-chip quanta sum never exceeds SHARE_QUANTA (checked
        # under the lock on every grant). Persisted with the status map;
        # indices that no longer exist under an overriding topology drop.
        self.shares: dict[int, dict[str, int]] = {}
        for k, owners in (state.get("shares", {})
                          if state is not None else {}).items():
            ik = int(k)
            if ik in self.status and owners:
                self.shares[ik] = {str(o): int(q) for o, q in owners.items()
                                   if int(q) > 0}
        with self._lock:
            self._persist()

    # ---- allocation ----

    @contextlib.contextmanager
    def _granting(self, kind: str):
        """Hold the scheduler lock for a grant, observing the grant
        latency AFTER the lock releases — the histogram's own lock and
        bucket scan must not lengthen the hottest serialized section
        (every concurrent mutation queues on self._lock). Failed grants
        (no placement) propagate without an observation, as before."""
        t0 = time.perf_counter()
        with self._lock:
            yield
        obs_metrics.GRANT_LATENCY.observe(
            (time.perf_counter() - t0) * 1e3, kind=kind)

    def apply(self, n: int, owner: str = "",
              reuse: Optional[list[int]] = None,
              plan: Optional[PlanSpec] = None,
              avoid: Optional[set] = None) -> list[int]:
        """Grant n chips as an ICI-contiguous set; returns chip indices.

        owner: who holds the grant (restore is owner-checked).
        reuse: chips ALREADY owned by `owner` that the placement may re-grant
        in place — the lift-in-place path for patch/rollback. They are never
        released to the pool, so no other applicant can grab them between the
        re-grant and the old container's teardown (chip exclusivity, SURVEY
        §7 hard part 2). Reused chips not in the new grant stay owned by
        `owner`; the caller restores them after the old container stops.
        plan: a non-trivial MeshPlan makes this a GANG grant — only an
        axis-aligned box whose geometry hosts the plan's axis factors
        (topology.plan_fits_box: tp/sp innermost on contiguous links, pp
        stages adjacent slabs) qualifies; there is no connected-set or
        fragmented fallback, because the workload will reshape the grant
        row-major into exactly this mesh and a fragmented grant would put
        the chattiest collectives on multi-hop paths.
        avoid: chips HARD-excluded from this placement (defrag.py's
        migrate-away path: the re-grant must not land back on the box
        being opened). Unlike apply_shares' soft anti-affinity, a grant
        that cannot be placed off the avoid set fails.
        """
        if n <= 0:
            return []
        if plan is not None and plan.is_trivial:
            plan = None
        if plan is not None and plan.size != n:
            raise ValueError(f"plan {plan.to_json()} sized {plan.size} "
                             f"cannot shape a {n}-chip grant")
        avoid = avoid or set()
        with trace.span("sched.gpu.apply", target=owner, n=n) as sp, \
                self._granting("gpu"):
            # cordoned chips are invisible to placement — not free, and not
            # reusable either: the whole point of a drain's re-grant is to
            # move the workload OFF them
            reusable = {i for i in (reuse or [])
                        if self.status.get(i) == owner
                        and i not in self.cordoned and i not in avoid}
            # chips carrying fractional shares are invisible to whole-chip
            # placement: granting one whole would oversubscribe its
            # co-tenants
            free = ({i for i, s in self.status.items()
                     if s is FREE and i not in self.cordoned
                     and i not in avoid
                     and not self.shares.get(i)} | reusable)
            if len(free) < n:
                raise xerrors.GpuNotEnoughError(
                    f"want {n}, only {len(free)} of {len(self.status)} "
                    f"allocatable ({len(self.cordoned)} cordoned, "
                    f"{len(self.shares)} share-split)")
            grant = self._find_box(n, free, prefer=reusable, plan=plan)
            if grant is None and plan is not None:
                raise xerrors.GpuNotEnoughError(
                    f"no free ICI-contiguous sub-mesh fits meshPlan "
                    f"{plan.to_json()} ({n} chips; "
                    f"{len(free)} free of {len(self.status)})")
            if grant is None:
                grant = self._find_connected(n, free, prefer=reusable)
            if grant is None:
                if not self.allow_fragmented:
                    raise xerrors.GpuNotEnoughError(
                        f"no ICI-contiguous placement for {n} chips")
                # prefer reused chips first to minimize churn
                grant = (sorted(reusable) + sorted(free - reusable))[:n]
            for i in grant:
                self.status[i] = owner
            self._persist()
            if sp is not None:
                sp.set(chips=sorted(grant))
            return sorted(grant)

    def restore(self, grant: list[int], owner: Optional[str] = None) -> None:
        """Free a grant. With an owner, only chips that owner still holds are
        freed — a stale restore can never release chips that have since been
        granted to someone else (the reference's unconditional byte-flip
        can, SURVEY §2 bug 3). owner=None is the administrative force-free."""
        if not grant:
            return
        with trace.span("sched.gpu.restore", target=owner or "",
                        chips=list(grant)), self._lock:
            for i in grant:
                if i in self.status and (owner is None or self.status[i] == owner):
                    self.status[i] = FREE
            self._persist()

    def mark_used(self, grant: list[int], owner: str = "") -> None:
        """Re-mark chips as held by `owner` — unwind path. Chips currently
        granted to a DIFFERENT owner are left alone."""
        if not grant:
            return
        with self._lock:
            for i in grant:
                if i in self.status and self.status[i] in (FREE, owner):
                    self.status[i] = owner
            self._persist()

    def claim(self, chips: list[int], owner: str,
              plan: Optional[PlanSpec] = None) -> list[int]:
        """Grant EXACTLY `chips` to `owner` — the placement layer's commit
        path: placement.py scores candidates over a fleet snapshot and
        then claims the winning box verbatim, so the chips chosen by the
        objective are the chips granted (re-running apply() could pick a
        different box if the pool moved between score and grant). Every
        chip must still be allocatable (free, not cordoned, not
        share-split) or the whole claim fails atomically with
        GpuNotEnoughError — the caller re-snapshots and re-scores."""
        if not chips:
            return []
        if plan is not None and plan.is_trivial:
            plan = None
        if plan is not None and plan.size != len(chips):
            raise ValueError(f"plan {plan.to_json()} sized {plan.size} "
                             f"cannot shape a {len(chips)}-chip claim")
        with trace.span("sched.gpu.claim", target=owner,
                        chips=list(chips)), self._granting("gpu"):
            stale = [i for i in chips
                     if self.status.get(i) is not FREE
                     or i in self.cordoned or self.shares.get(i)]
            if stale:
                raise xerrors.GpuNotEnoughError(
                    f"claim of {sorted(chips)} lost chips {sorted(stale)} "
                    f"between score and grant; re-score")
            for i in chips:
                self.status[i] = owner
            self._persist()
            return sorted(chips)

    # ---- fractional shares ----

    def _shares_used(self, chip: int) -> int:
        return sum(self.shares.get(chip, {}).values())

    def apply_shares(self, quanta: int, owner: str,
                     prefer: Optional[int] = None,
                     avoid: Optional[set] = None,
                     strict_avoid: bool = False) -> int:
        """Grant `quanta` shares (quanta/SHARE_QUANTA of a chip) on ONE
        chip; returns the chip index. Placement is bin-packing: the
        already-most-shared chip with capacity wins (fills partial chips
        before splitting a fresh one — whole-chip placements keep the
        most contiguous free space), `prefer` (the lift-in-place chip on
        a patch) beating everything when it still fits. `avoid` is a SOFT
        anti-affinity set — chips hosting sibling replicas of the same
        gateway: spread across chips when capacity allows (one chip's
        regulator must not serialize all of a gateway's replicas), fall
        back to packing when it doesn't. Never a cordoned or
        whole-granted chip; the per-chip ledger can never exceed
        SHARE_QUANTA. Raises GpuOversubscribedError when no chip fits.
        strict_avoid upgrades the avoid set to a HARD exclusion (the
        defrag migrate-away path — a share re-granted inside the box
        being opened would undo the eviction)."""
        if not 0 < quanta < SHARE_QUANTA:
            raise ValueError(f"share quanta must be 1..{SHARE_QUANTA - 1}, "
                             f"got {quanta}")
        with trace.span("sched.gpu.apply_shares", target=owner,
                        quanta=quanta) as sp, self._granting("gpu_shares"):
            cands = [i for i, s in self.status.items()
                     if s is FREE and i not in self.cordoned
                     and self._shares_used(i) + quanta <= SHARE_QUANTA]
            if not cands:
                raise xerrors.GpuOversubscribedError(
                    f"want {quanta}/{SHARE_QUANTA} of a chip; no chip has "
                    f"that much free share capacity "
                    f"({len(self.shares)} share-split, "
                    f"{len(self.cordoned)} cordoned)")
            if avoid:
                spread = [i for i in cands if i not in avoid]
                if strict_avoid and not spread:
                    raise xerrors.GpuOversubscribedError(
                        f"want {quanta}/{SHARE_QUANTA} of a chip off "
                        f"{len(avoid)} avoided chip(s); no other chip has "
                        f"that much free share capacity")
                cands = spread or cands      # soft: packing beats failing
            if prefer in cands:
                chip = prefer
            else:
                chip = min(cands, key=lambda i: (-self._shares_used(i), i))
            owners = self.shares.setdefault(chip, {})
            owners[owner] = owners.get(owner, 0) + quanta
            self._persist()
            if sp is not None:
                sp.set(chip=chip)
            return chip

    def restore_shares(self, chip: int, quanta: int, owner: str) -> int:
        """Return share quanta to the pool — owner-checked and EXACT: at
        most what `owner` still holds on `chip` is freed, so a stale or
        duplicated release can never free a co-tenant's shares (the same
        double-free class restore() guards for whole chips). Returns the
        quanta actually freed."""
        with trace.span("sched.gpu.restore_shares", target=owner,
                        chip=chip, quanta=quanta), self._lock:
            owners = self.shares.get(chip)
            if not owners or owner not in owners:
                return 0
            take = min(owners[owner], max(quanta, 0))
            if take:
                left = owners[owner] - take
                if left:
                    owners[owner] = left
                else:
                    del owners[owner]
                if not owners:
                    del self.shares[chip]
                self._persist()
            return take

    def release_owner_shares(self, owner: str) -> list[int]:
        """Drop every share grant held by `owner` (the reconciler's
        free-all path for unwound replicaSets). Returns the chips
        touched."""
        with self._lock:
            touched = [i for i, owners in self.shares.items()
                       if owner in owners]
            for i in touched:
                del self.shares[i][owner]
                if not self.shares[i]:
                    del self.shares[i]
            if touched:
                self._persist()
            return touched

    def set_shares(self, chip: int, owner: str, quanta: int) -> None:
        """Force `owner`'s holding on `chip` to exactly `quanta` (0
        removes) — the reconciler's repair primitive when the stored
        records and the ledger disagree. Clamped so the chip's total can
        never exceed SHARE_QUANTA even against a corrupt store."""
        with self._lock:
            if chip not in self.status:
                return
            owners = self.shares.setdefault(chip, {})
            others = sum(q for o, q in owners.items() if o != owner)
            want = max(0, min(quanta, SHARE_QUANTA - others))
            if want:
                owners[owner] = want
            else:
                owners.pop(owner, None)
            if not owners:
                self.shares.pop(chip, None)
            self._persist()

    # ---- cordon / uncordon ----

    def cordon(self, chips: list[int]) -> list[int]:
        """Exclude chips from all future placements. A cordoned chip that
        is currently GRANTED keeps its owner — cordon never yanks a live
        workload; drain (services/replicaset.py drain_cordoned) migrates
        it through the rolling-replace path. Returns the full cordoned
        set. Unknown indices raise ValueError (an operator typo must not
        silently no-op)."""
        with self._lock:
            bad = [i for i in chips if i not in self.status]
            if bad:
                raise ValueError(f"unknown chip index(es) {bad} "
                                 f"(topology has {len(self.status)} chips)")
            self.cordoned.update(chips)
            self._persist()
            return sorted(self.cordoned)

    def uncordon(self, chips: list[int]) -> list[int]:
        with self._lock:
            self.cordoned.difference_update(chips)
            self._persist()
            return sorted(self.cordoned)

    # ---- placement search ----

    def _find_box(self, n: int, free: set[int],
                  prefer: Optional[set[int]] = None,
                  plan: Optional[PlanSpec] = None) -> Optional[list[int]]:
        """Best free axis-aligned box of volume n: compact dims first, then
        max overlap with `prefer` (the lift-in-place chips on a patch —
        SURVEY §7 hard part 1: the new grant should CONTAIN the old one
        when an equally good box does), then the most packed placement
        (fewest free ICI neighbors outside the box — keeps the remaining
        free space contiguous). With native_finder, the C++ core
        (native/topology_alloc.cc, _native_find_box) searches first when
        it loads.

        With a plan, only boxes whose geometry hosts the plan's axis
        factors qualify (topology.plan_fits_box), and among those the
        placement whose tp*sp inner chunks split across the fewest hosts
        wins the tie — "tp/sp inside a host where possible" is a score,
        not a hard requirement, exactly like the whole-box worker span."""
        prefer = prefer or set()
        # the native core is gated BEHIND the memo: it doesn't score
        # worker spans, so when no candidate box of this size is
        # single-worker (cands sort (span, sa)-ascending — check the
        # head) its pick would always be discarded below and the call
        # would be a pure pessimization on top of the python scan
        if self.native_finder and plan is None \
                and (cands := self._box_candidates(n)) and cands[0][4] == 1:
            native = self._native_find_box(n, free)
            if native is not None:
                if not native:
                    return None  # core searched the same space: no box exists
                # the core doesn't score worker spans or reuse overlap —
                # accept its pick only when neither axis could rank another
                # box higher (full prefer containment can't be beaten on
                # the overlap axis)
                if (prefer <= set(native)
                        and len(self.topology.workers_spanned(native)) == 1):
                    return native
        factors = plan.factors() if plan is not None else None
        inner = (plan.tp * plan.sp) if plan is not None else 1
        best: Optional[list[int]] = None
        best_key: Optional[tuple] = None
        for idx, box, ext, sa, span, origin, dims in self._box_candidates(n):
            # candidates are sorted by (span, sa) — once a fit exists, no
            # later candidate with a strictly worse rank prefix can win
            if best_key is not None and (span, sa) > best_key[:2]:
                break
            if factors is not None and not plan_fits_box(dims, factors):
                continue
            if not box <= free:
                continue
            # exterior free links = fragmentation damage; fewer is better
            ext_free = sum(1 for e in ext if e in free)
            key = (span, sa, self._inner_host_splits(idx, inner),
                   -len(box & prefer), ext_free,
                   origin[2], origin[1], origin[0])
            if best_key is None or key < best_key:
                best_key = key
                best = idx
        return best

    def _inner_host_splits(self, idx: list[int], inner: int) -> int:
        """How many row-major inner (tp*sp) chunks of a candidate grant
        span more than one TPU VM host. 0 for non-plan grants — the
        term then never reorders the legacy ranking."""
        if inner <= 1:
            return 0
        wof = self.topology.worker_of
        return sum(
            1 for i in range(0, len(idx), inner)
            if len({wof(j) for j in idx[i:i + inner]}) > 1)

    def _box_candidates(self, n: int) -> list[tuple]:
        """Memoized per-n candidate boxes as
        (indices, index_frozenset, exterior_neighbor_indices, surface_area,
        workers_spanned, origin, dims) — everything about a candidate that
        does not depend on the current free set. span ranks first: an
        intra-host grant needs no cross-host process mesh (and one
        container, not K)."""
        cached = self._box_cache.get(n)
        if cached is None:
            topo = self.topology
            cached = []
            for origin, dims in topo.sub_boxes(n):
                idx = topo.box_indices(origin, dims)
                box = frozenset(idx)
                ext = tuple(nb.index for i in idx
                            for nb in topo.neighbors(topo.chip(i))
                            if nb.index not in box)
                sa = dims[0] * dims[1] + dims[1] * dims[2] + dims[0] * dims[2]
                cached.append((idx, box, ext, sa,
                               len(topo.workers_spanned(idx)), origin, dims))
            # (span, sa)-ascending lets _find_box stop at the first rank
            # class that yields a fit
            cached.sort(key=lambda c: (c[4], c[3]))
            self._box_cache[n] = cached
        return cached

    def plan_feasible(self, plan: PlanSpec) -> bool:
        """Whether ANY sub-box of this topology could host `plan`
        (geometry only — ignores occupancy). The admission check behind
        the API's meshPlan validation: a plan that fails here can never
        be granted on this slice, so the request is a client error (1000),
        not a capacity 1012."""
        if plan.is_trivial:
            return True
        n = plan.size
        if n > len(self.status) or not self.topology.ici_connected:
            return False
        factors = plan.factors()
        return any(plan_fits_box(dims, factors)
                   for *_, dims in self._box_candidates(n))

    def _native_find_box(self, n: int, free: set[int]) -> Optional[list[int]]:
        """C++ box search. Returns None when the core doesn't apply (torus,
        lib missing), [] when it applies but found nothing, else a candidate
        grant (caller re-checks worker span)."""
        if self.topology.wraparound:
            return None
        from .._native import load
        lib = load("topoalloc")
        if lib is None:
            return None
        import ctypes
        sx, sy, sz = self.topology.shape
        total = sx * sy * sz
        # bulk-fill through a bytearray: the per-index ctypes __setitem__
        # loop was the dominant cost of the whole native call
        raw = bytearray(b"\x01" * total)
        for i in free:
            raw[i] = 0
        status = (ctypes.c_int8 * total).from_buffer(raw)
        out = (ctypes.c_int32 * n)()
        ok = lib.topo_find_box(sx, sy, sz, status, n, out)
        return [int(out[i]) for i in range(n)] if ok else []

    def enumerate_candidates(self, n: int,
                             plan: Optional[PlanSpec] = None) -> list[dict]:
        """Every fully-free axis-aligned box of volume n as a scored-grant
        candidate — the placement layer's read surface. first-fit's
        _find_box keeps its own early-exit ranking; this returns the WHOLE
        candidate set (plan-compatible boxes only, when a plan is given)
        so pluggable objectives can rank them by something other than
        compactness. Each dict carries the geometry facts an objective may
        score on; chips are sorted row-major for a direct claim()."""
        if n <= 0:
            return []
        if plan is not None and plan.is_trivial:
            plan = None
        factors = plan.factors() if plan is not None else None
        inner = (plan.tp * plan.sp) if plan is not None else 1
        with self._lock:
            free = {i for i, s in self.status.items()
                    if s is FREE and i not in self.cordoned
                    and not self.shares.get(i)}
            out = []
            for idx, box, ext, sa, span, origin, dims in \
                    self._box_candidates(n):
                if factors is not None and not plan_fits_box(dims, factors):
                    continue
                if not box <= free:
                    continue
                out.append({
                    "chips": list(idx),
                    "dims": list(dims),
                    "origin": list(origin),
                    "span": span,
                    "surface": sa,
                    "extFree": sum(1 for e in ext if e in free),
                    "hostSplits": self._inner_host_splits(idx, inner),
                })
            return out

    def capacity_view(self) -> dict:
        """Per-pool capacity summary for fleet-level placement: allocatable
        whole chips + share quanta, the largest fully-free box, and a
        fragmentation ratio (1 - largest_box/free_chips — 0 when all free
        capacity is one box, →1 as free chips shatter). The defragmenter
        triggers on exactly this signal: plan_feasible says the geometry
        COULD host a gang, free chips suffice, yet largestFreeBox < n."""
        with self._lock:
            free = {i for i, s in self.status.items()
                    if s is FREE and i not in self.cordoned
                    and not self.shares.get(i)}
            free_q = sum(self._allocatable_quanta(i) for i in self.status)
            largest = 0
            for n in range(len(free), 0, -1):
                if any(box <= free
                       for _, box, *_ in self._box_candidates(n)):
                    largest = n
                    break
            return {
                "generation": self.topology.generation,
                "acceleratorType": self.topology.accelerator_type,
                "totalChips": len(self.status),
                "freeChips": len(free),
                "freeQuanta": free_q,
                "cordoned": len(self.cordoned),
                "shareSplit": len(self.shares),
                "largestFreeBox": largest,
                "fragmentation": round(1.0 - largest / len(free), 4)
                                 if free else 0.0,
            }

    def _find_connected(self, n: int, free: set[int],
                        prefer: Optional[set[int]] = None,
                        ) -> Optional[list[int]]:
        """Connected free set of n chips via greedy BFS from each free seed,
        preferring sets that overlap `prefer` (lift-in-place chips), then
        tight bounding boxes.

        COMPLETE for existence: from each seed the loop keeps absorbing
        frontier neighbors until either n chips are picked or the seed's
        entire connected component is exhausted — so whenever any free
        component holds >= n chips, a connected grant is returned (any
        connected graph with >= n vertices contains a connected n-subgraph,
        and BFS absorption constructs one). Only the bounding-box TIGHTNESS
        of the returned set is heuristic (the tie-break which frontier chip
        to absorb next); tests/test_schedulers.py pins both properties on
        snake- and L-shaped free regions."""
        topo = self.topology
        prefer = prefer or set()
        best: Optional[list[int]] = None
        best_key: Optional[tuple] = None
        # prefer-chips seed first: absorption growing out of the old grant
        # maximizes its chance of being contained
        for seed in sorted(free, key=lambda i: (i not in prefer, i)):
            picked = [seed]
            frontier = [nb.index for nb in topo.neighbors(topo.chip(seed))
                        if nb.index in free]
            seen = {seed}
            while len(picked) < n and frontier:
                # pick the frontier chip keeping the bounding box tightest,
                # prefer-chips breaking ties
                def vol_with(i: int) -> tuple:
                    coords = [topo.chip(p).coord for p in picked] + [topo.chip(i).coord]
                    return (_bbox_volume(coords), i not in prefer)
                frontier.sort(key=vol_with)
                nxt = frontier.pop(0)
                if nxt in seen:
                    continue
                seen.add(nxt)
                picked.append(nxt)
                for nb in topo.neighbors(topo.chip(nxt)):
                    if nb.index in free and nb.index not in seen:
                        frontier.append(nb.index)
            if len(picked) == n:
                vol = _bbox_volume([topo.chip(p).coord for p in picked])
                key = (-len(set(picked) & prefer), vol)
                if best_key is None or key < best_key:
                    best_key = key
                    best = picked
                if best_key == (-min(len(prefer), n), n):
                    break     # full overlap at perfect-box volume: optimal
        return best

    # ---- status / env ----

    def get_status(self) -> dict:
        """Copy of card status + topology, for GET /resources/tpus
        (reference GetGpuStatus, gpuscheduler.go:147-157)."""
        with self._lock:
            chips = [{
                "index": c.index,
                "id": c.id,
                "device": c.device_path,
                "coord": list(c.coord),
                "used": (self.status[c.index] is not FREE
                         or bool(self.shares.get(c.index))),
                "owner": self.status[c.index] or "",
                "cordoned": c.index in self.cordoned,
                "shares": dict(self.shares.get(c.index, {})),
                "freeShares": self._allocatable_quanta(c.index),
                # the card's identity, where discovery read it
                **({"uuid": c.uuid, "name": c.name} if c.uuid else {}),
            } for c in self.topology.chips]
            free_q = sum(self._allocatable_quanta(i) for i in self.status)
            fc = free_q / SHARE_QUANTA
            return {
                "topology": self.topology.serialize(),
                "chips": chips,
                # freeCount = ALLOCATABLE capacity in chip units,
                # fractional capacity included: a half-shared chip counts
                # its remaining shares (int when integral so share-unaware
                # clients keep seeing whole numbers); a cordoned-but-
                # unowned chip is not capacity anyone can be granted
                "freeCount": int(fc) if fc == int(fc) else fc,
                "freeShares": free_q,
                "cordoned": sorted(self.cordoned),
            }

    def _allocatable_quanta(self, chip: int) -> int:
        """Share quanta still grantable on `chip`: 0 when cordoned or
        whole-granted, else the ledger remainder (SHARE_QUANTA when the
        chip is fully free)."""
        if chip in self.cordoned or self.status.get(chip) is not FREE:
            return 0
        return SHARE_QUANTA - self._shares_used(chip)

    def shares_snapshot(self) -> dict[int, dict[str, int]]:
        """Locked deep copy of the share ledger ({chip: {owner: quanta}}) —
        the cross-object read surface (see Scheduler.owners): the live
        nested dicts mutate under concurrent grants/releases."""
        with self._lock:
            return {c: dict(o) for c, o in self.shares.items()}

    def cordoned_snapshot(self) -> set[int]:
        """Locked copy of the cordoned set — reading the live set from
        another thread races cordon/uncordon mutations."""
        with self._lock:
            return set(self.cordoned)

    def snapshot(self) -> dict:
        """ONE consistent locked view {status, shares, cordoned}. The race
        sweep's invariant checker asserts cross-map invariants (bitmap/
        ledger disjointness, per-chip quanta caps) that two separately
        locked snapshots cannot establish race-free — a chip whole-granted
        between an owners() and a shares_snapshot() call would look
        double-booked when it never was."""
        with self._lock:
            return {"status": dict(self.status),
                    "shares": {c: dict(o) for c, o in self.shares.items()},
                    "cordoned": set(self.cordoned)}

    def env_for(self, grant: list[int],
                plan: Optional[PlanSpec] = None) -> dict[str, str]:
        """Card env for a grant (topology.visible_chips_env): the cards in
        CUDA_VISIBLE_DEVICES under CUDA_DEVICE_ORDER=PCI_BUS_ID, and the
        worker contract. A plan (trivial included — an explicitly requested
        dp=1 pins the workload to a 1-device mesh) additionally stamps
        TDAPI_MESH_PLAN; None stamps nothing (the workload's auto-mesh)."""
        plan_d = plan.to_json() if plan is not None else None
        return self.topology.visible_chips_env(grant, plan=plan_d)

    def device_paths(self, grant: list[int]) -> list[str]:
        """The granted cards' device nodes (/dev/nvidia<minor>)."""
        return [self.topology.chip(i).device_path for i in grant]

    def serialize(self) -> dict:
        return {
            "topology": self.topology.serialize(),
            "status": {str(k): v for k, v in self.status.items()},
            "cordoned": sorted(self.cordoned),
            "shares": {str(k): dict(v) for k, v in self.shares.items()},
        }


def _bbox_volume(coords: list[tuple[int, int, int]]) -> int:
    vol = 1
    for a in range(3):
        vals = [c[a] for c in coords]
        vol *= max(vals) - min(vals) + 1
    return vol


def _stored_topology(d: dict) -> GpuTopology:
    """The topology a stored state describes (either package's keys; a
    `devices` list names each card's node where it is not the default,
    `uuids` and `names` each card's identity where discovery read it)."""
    shape = tuple(d["shape"])
    n = shape[0] * shape[1] * shape[2]
    workers = d.get("numWorkers", 1)
    topo = GpuTopology(
        accelerator_type=d["acceleratorType"],
        generation=d["generation"],
        shape=shape,  # type: ignore[arg-type]
        wraparound=d.get("wraparound", False),
        worker_id=d.get("workerId", 0),
        num_workers=workers,
        chips_per_host=d.get("chipsPerHost", -(-n // max(workers, 1))),
        ici_connected=d.get("iciConnected", True),
    )
    devices = d.get("devices") or [c.device_path for c in topo.chips]
    uuids = d.get("uuids") or [""] * len(topo.chips)
    names = d.get("names") or [""] * len(topo.chips)
    if d.get("devices") or d.get("uuids") or d.get("names"):
        topo = GpuTopology(
            topo.accelerator_type, topo.generation, topo.shape,
            chips=[Chip(c.index, c.coord, path, uuid, name)
                   for c, path, uuid, name
                   in zip(topo.chips, devices, uuids, names)],
            wraparound=topo.wraparound, chips_per_host=topo.chips_per_host,
            worker_id=topo.worker_id, num_workers=topo.num_workers,
            ici_connected=topo.ici_connected)
    return topo
