"""Defragmenting preemptive migrator.

The port's copy of the JAX control plane's defrag.py, over the card
scheduler's line of cards.

Gang grants need a contiguous box; long-running fleets shatter.
The failure mode this module exists for (MIG-reconfiguration paper,
arXiv:2109.11067): ``plan_feasible`` says the geometry COULD host the
gang and total free capacity suffices, yet no free box exists — the
request is blocked purely by fragmentation, and no amount of waiting
fixes it because small tenants churn in place.

The ``Defragmenter`` detects exactly that state (scheduler
``capacity_view``: freeChips >= n but largestFreeBox < n), picks the
candidate box whose occupants are cheapest to move, and evicts them via
the existing quiesce -> CoW-move -> re-grant ladder
(``ReplicaSetService.migrate_replicaset`` with the box as a HARD avoid
set), under a migration-cost budget so defrag never spends more chip-time
moving tenants than the gang admission buys.

Crash safety: a defrag run journals an umbrella ``defrag`` intent
(per-tenant migrations journal their own ``replace`` intents — those do
the real recovery), with crashpoints ``defrag.after_plan`` and
``defrag.after_migrate`` swept by the crash-recovery tests. The run
is idempotent: re-running after a crash re-diagnoses against live state,
skips already-moved tenants (they no longer occupy the box), and finishes
the eviction.

Federation: on a fleet member, defrag only ever migrates replicaSets the
local daemon OWNS (the ``owns`` callable) — migrating a peer's tenant
would race its owner's mutations.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from . import xerrors
from .faults import crashpoint
from .meshplan import PlanSpec
from .schedulers.base import FREE
from .topology import plan_fits_box

log = logging.getLogger("tdapi.defrag")

# default migration budget: chips moved per run may not exceed
# max(gang size, this floor) — opening an n-chip box by moving > n chips
# of tenants is already suspect; the env knob widens it for operators who
# value gang admission over churn
DEFAULT_BUDGET_FLOOR = int(os.environ.get("TDAPI_DEFRAG_BUDGET", "0") or 0)


class Defragmenter:
    def __init__(self, fleet, replicasets, events=None,
                 owns: Optional[Callable[[str], bool]] = None,
                 budget: int = 0):
        self.fleet = fleet                  # placement.FleetModel
        self.replicasets = replicasets      # ReplicaSetService
        self.events = events
        self.owns = owns                    # None = single-daemon: owns all
        self.budget = budget                # 0 = max(n, DEFAULT_BUDGET_FLOOR)
        self._lock = threading.Lock()
        # pending fragmentation-blocked gang shapes noted by the admission
        # path; the background loop retries them
        self._pending: list[tuple[int, Optional[dict]]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.runs_total = 0
        self.migrations_total = 0
        self.moved_chips_total = 0
        self.steps_lost_total = 0
        self.denied_total = 0
        self.last_run_ms = 0.0

    # ---- diagnosis ----

    def _budget_for(self, n: int) -> int:
        return self.budget or max(n, DEFAULT_BUDGET_FLOOR)

    def diagnose(self, n: int,
                 plan: Optional[PlanSpec] = None) -> list[dict]:
        """Pools where an n-chip (plan-shaped) gang is geometry-feasible
        and capacity-feasible but fragmentation-blocked: no free box,
        enough free chips."""
        if plan is not None and plan.is_trivial:
            plan = None
        factors = plan.factors() if plan is not None else None
        out = []
        for pname in sorted(self.fleet.pools):
            sched = self.fleet.pools[pname]
            if plan is not None and not sched.plan_feasible(plan):
                continue
            if sched.enumerate_candidates(n, plan=plan):
                continue                  # a free box exists: not blocked
            cv = sched.capacity_view()
            if cv["freeChips"] < n:
                continue                  # genuinely out of capacity
            boxes = sched._box_candidates(n)
            if factors is None and not boxes:
                continue                  # geometry can never host n
            out.append({"pool": pname, "n": n,
                        "freeChips": cv["freeChips"],
                        "largestFreeBox": cv["largestFreeBox"]})
        return out

    def plan_eviction(self, pool: str, n: int,
                      plan: Optional[PlanSpec] = None) -> Optional[dict]:
        """Cheapest way to open an n-chip box in `pool`: for every
        plan-compatible candidate box, cost = chips its occupants hold
        fleet-wide (evicting a tenant migrates its WHOLE grant). A box is
        viable only when every occupant is migratable (owned here, not
        cordoned-pinned), the free chips OUTSIDE the box can absorb the
        moved whole-chip grants, and the total stays within budget.
        Pure planning — reads one locked scheduler snapshot, mutates
        nothing."""
        if plan is not None and plan.is_trivial:
            plan = None
        factors = plan.factors() if plan is not None else None
        sched = self.fleet.pools[pool]
        snap = sched.snapshot()
        status, shares = snap["status"], snap["shares"]
        cordoned = snap["cordoned"]
        owner_chips: dict[str, list[int]] = {}
        for i, s in status.items():
            if s is not FREE and s:
                owner_chips.setdefault(s, []).append(i)
        free_all = {i for i, s in status.items()
                    if s is FREE and i not in cordoned and not shares.get(i)}
        budget = self._budget_for(n)
        best: Optional[dict] = None
        for idx, box, _ext, _sa, _span, _origin, dims in \
                sched._box_candidates(n):
            if factors is not None and not plan_fits_box(dims, factors):
                continue
            if box & cordoned:
                continue                  # can't free a cordoned chip
            occupied = [i for i in idx if status[i] is not FREE]
            if any(not status[i] for i in occupied):
                continue                  # anonymous legacy grant: unmovable
            whole_owners = {status[i] for i in occupied}
            share_tenants = {o for i in idx
                             for o in (shares.get(i) or {})}
            if not whole_owners and not share_tenants:
                continue                  # fully free — caller would've won
            if self.owns is not None and any(
                    not self.owns(o)
                    for o in whole_owners | share_tenants):
                continue                  # peer-owned tenant: not ours to move
            moved = (sum(len(owner_chips.get(o, ())) for o in whole_owners)
                     + len(share_tenants))
            if moved > budget:
                continue
            # every evicted whole grant must re-place OUTSIDE the box
            if sum(len(owner_chips.get(o, ()))
                   for o in whole_owners) > len(free_all - box):
                continue
            key = (moved, len(whole_owners) + len(share_tenants),
                   tuple(sorted(idx)))
            if best is None or key < best["_key"]:
                best = {"_key": key, "pool": pool, "box": sorted(idx),
                        "dims": list(dims),
                        "evict": sorted(whole_owners | share_tenants),
                        "movedChips": moved, "budget": budget}
        if best is not None:
            del best["_key"]
        return best

    # ---- execution ----

    def run_for(self, n: int, plan: Optional[PlanSpec] = None,
                requester: str = "") -> dict:
        """Open a contiguous n-chip box for a fragmentation-blocked
        gang: diagnose, plan the cheapest eviction, migrate every
        occupant off the target box. Returns a report; ``opened`` True
        means the box is free and the gang can be re-admitted."""
        t0 = time.perf_counter()
        with self._lock:
            self.runs_total += 1
        if plan is not None and plan.is_trivial:
            plan = None
        blocked = self.diagnose(n, plan)
        report: dict = {"n": n, "opened": False, "migrations": [],
                        "movedChips": 0, "stepsLost": 0}
        ev_plan = None
        for b in blocked:
            ev_plan = self.plan_eviction(b["pool"], n, plan)
            if ev_plan is not None:
                break
        if ev_plan is None:
            with self._lock:
                self.denied_total += 1
            reason = ("not fragmentation-blocked" if not blocked
                      else "no eviction plan within budget")
            report["denied"] = reason
            if self.events is not None:
                self.events.record("defrag.deny", target=requester,
                                   n=n, reason=reason)
            self.last_run_ms = (time.perf_counter() - t0) * 1e3
            return report
        pool, box = ev_plan["pool"], set(ev_plan["box"])
        # umbrella intent: records that a defrag was mid-flight (the
        # per-tenant replace intents carry the real recovery); target is
        # namespaced so it can never collide with a replicaSet's own
        # intent key
        intent = self.replicasets.intents.begin(
            "defrag", f"defrag:{pool}", n=n,
            box=ev_plan["box"], evict=ev_plan["evict"],
            movedChips=ev_plan["movedChips"])
        intent.step("planned", sync=True, pool=pool)
        if self.events is not None:
            self.events.record("defrag.plan", target=pool, n=n,
                               box=ev_plan["box"], evict=ev_plan["evict"],
                               movedChips=ev_plan["movedChips"],
                               budget=ev_plan["budget"])
        crashpoint("defrag.after_plan")
        migrated_any = False
        try:
            for tenant in ev_plan["evict"]:
                try:
                    item = self.replicasets.migrate_replicaset(
                        tenant, via="defrag", avoid=box)
                except xerrors.NotExistInStoreError:
                    continue          # deleted since the plan: box opened
                report["migrations"].append(item)
                with self._lock:
                    self.migrations_total += 1
                    self.moved_chips_total += len(item["toChips"])
                    self.steps_lost_total += item["stepsLost"] or 0
                report["stepsLost"] += item["stepsLost"] or 0
                report["movedChips"] += len(item["toChips"])
                if self.events is not None:
                    self.events.record(
                        "defrag.migrate", target=tenant, pool=pool,
                        fromChips=item["fromChips"],
                        toChips=item["toChips"],
                        quiesced=item["quiesced"],
                        stepsLost=item["stepsLost"])
                if not migrated_any:
                    migrated_any = True
                    crashpoint("defrag.after_migrate")
        except Exception as e:
            # a failed eviction leaves already-moved tenants moved (their
            # replaces committed); re-running re-plans around them
            intent.done()
            with self._lock:
                self.denied_total += 1
            report["denied"] = str(e)
            log.exception("defrag: eviction in pool %s failed", pool)
            if self.events is not None:
                self.events.record("defrag.deny", target=requester,
                                   n=n, pool=pool, reason=str(e), code=500)
            self.last_run_ms = (time.perf_counter() - t0) * 1e3
            return report
        intent.done()
        # opened iff the box's chips are now a free candidate again
        opened = bool(self.fleet.pools[pool].enumerate_candidates(
            n, plan=plan))
        report.update({"opened": opened, "pool": pool,
                       "box": ev_plan["box"]})
        self.last_run_ms = (time.perf_counter() - t0) * 1e3
        if self.events is not None:
            self.events.record("defrag.admit" if opened else "defrag.deny",
                               target=requester or pool, pool=pool, n=n,
                               movedChips=report["movedChips"],
                               stepsLost=report["stepsLost"],
                               durationMs=round(self.last_run_ms, 2))
        return report

    # ---- background loop ----

    def note_infeasible(self, n: int, plan_json: Optional[dict]) -> None:
        """Admission path hook: a gang grant just failed on capacity.
        Queued for the background loop (dedup'd by shape)."""
        with self._lock:
            key = (n, plan_json)
            if key not in self._pending:
                self._pending.append(key)

    def start(self, interval: float) -> None:
        if self._thread is not None or interval <= 0:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                with self._lock:
                    pending, self._pending = self._pending, []
                for n, plan_json in pending:
                    try:
                        plan = (PlanSpec.from_spec(plan_json)
                                if plan_json else None)
                        self.run_for(n, plan)
                    except Exception:  # noqa: BLE001 — keep the loop alive
                        log.exception("defrag: background run failed")

        self._thread = threading.Thread(target=loop, name="tdapi-defrag",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # ---- status ----

    def describe(self) -> dict:
        with self._lock:
            return {
                "budgetFloor": self.budget or DEFAULT_BUDGET_FLOOR,
                "pending": len(self._pending),
                "running": self._thread is not None,
                "runsTotal": self.runs_total,
                "migrationsTotal": self.migrations_total,
                "movedChipsTotal": self.moved_chips_total,
                "stepsLostTotal": self.steps_lost_total,
                "deniedTotal": self.denied_total,
                "lastRunMs": round(self.last_run_ms, 2),
            }
