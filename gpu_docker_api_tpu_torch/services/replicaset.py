"""ReplicaSet service — the versioned-container state machine.

The port's copy of the JAX control plane's services/replicaset.py, on the
card scheduler. Reference parity: internal/services/replicaset.go (1047
LoC) + the runContainer build-tag pair (replicaset_nomock.go /
replicaset_mock.go):

- run      = bump version, grant cards/cores/ports, create+start {rs}-{v}
             (reference RunGpuContainer :45-155 + runContainer)
- patch    = rolling replacement: new version with lifted config, old
             upper-dir copied into new, old deleted (reference :267-363)
- rollback = forward-write a new version whose config equals a historical
             one (reference :365-446) — history is append-only
- restart  = full re-grant + new version (reference :736-864)
- stop     = release cards/cores/ports, stop container (reference :582-639)
- pause / continue / execute / commit / info / history / delete

Resource-ownership model: every grant is owned by the replicaSet name;
restores are owner-checked, so a stale release can never free another
replicaSet's resources. Grant lifecycle per replicaSet:

    run: apply(owner=name)                       [held]
    patch/rollback/restart(running):
        apply(owner=name, reuse=old_grant)       [held; old cards NEVER
        ... stop old, start new ...               transit through the free
        restore(old - new, owner=name)            pool -> no thief window,
                                                  and card exclusivity holds]
    stop: restore(owner=name); resourcesReleased=True persisted
    delete: restore(owner=name) unless released  [covers crash-exited
                                                  containers too]

On the card:
- the grant is the card scheduler's (`tpu` is a GpuScheduler: the
  attribute, the `tpuCount` field and the stored `tpu_chips` / `tpu_env` /
  `devices` keep JAX's names, so the stored JSON keeps JAX's layout, with
  CUDA_VISIBLE_DEVICES and /dev/nvidia<minor> as the values);
- card exclusivity: during a replacement the OLD container is stopped
  BEFORE the new one starts, and the in-place `reuse=` grant keeps the
  card out of the free pool throughout;
- no compile-cache injection: JAX's service points every workload at a
  host-shared XLA cache (JAX_COMPILATION_CACHE_DIR); a torch workload
  reads none, and the port's kernels are built once into the package's
  own build directory, which every container on the host shares, so the
  env and binds stay as the request gave them;
- history durability: every version persists under an explicit
  per-version key, so rollback survives store compaction.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

from typing import Optional

from .. import xerrors
from ..backend.base import Backend
from ..dtos import (
    ContainerRun, ContainerSpec, HistoryItem, PatchRequest, StoredContainerInfo,
)
from ..faults import crashpoint
from ..intents import Intent, IntentJournal
from ..meshplan import PlanSpec, stored_plan
from ..obs import trace
from ..schedulers import (
    SHARE_QUANTA, CpuScheduler, GpuScheduler, PortScheduler, parse_gpu_count,
)
from ..store.client import StateClient
from ..utils.file import to_bytes
from ..version import MergeMap, VersionMap
from ..workqueue import Call, PutKeyValue, WorkQueue

log = logging.getLogger(__name__)

CONTAINERS = "containers"


def _now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


# ---- workload quiesce knobs (checkpoint-on-drain; backend/base.py) ----

def quiesce_enabled() -> bool:
    """Global kill switch: TDAPI_QUIESCE=0 restores the plain
    stop-and-replay migration everywhere (read per call so a live daemon
    can be flipped)."""
    import os
    return os.environ.get("TDAPI_QUIESCE", "1").lower() not in (
        "0", "false", "no")


def quiesce_timeout() -> float:
    """Bound on the checkpoint-now wait (TDAPI_QUIESCE_TIMEOUT, seconds).
    On expiry the replace falls back to today's stop — a slow checkpoint
    must never wedge a drain."""
    import os
    try:
        return float(os.environ.get("TDAPI_QUIESCE_TIMEOUT", "") or 30.0)
    except ValueError:
        return 30.0


def spec_wants_quiesce(spec: ContainerSpec) -> bool:
    """Per-workload opt-in: the container's env carries TDAPI_QUIESCE=1
    (set by the operator who wired the SIGUSR1 handler — train.py). A
    workload WITHOUT a handler dies on SIGUSR1 (default disposition), so
    quiesce is never sprayed at arbitrary containers."""
    for kv in spec.env:
        k, _, v = kv.partition("=")
        if k == "TDAPI_QUIESCE":
            return v.lower() not in ("", "0", "false", "no")
    return False


def _read_quiesce_ack(upper_dir: str):
    """The parked step from the workload's ack file, or None. Best-effort:
    the ack's existence (backend.quiesce returning True) is the contract;
    the step inside is observability."""
    import json
    import os
    try:
        with open(os.path.join(upper_dir, Backend.QUIESCE_ACK)) as f:
            step = json.load(f).get("step")
        return int(step) if step is not None else None
    except (OSError, ValueError, TypeError, json.JSONDecodeError):
        return None


class ReplicaSetService:
    def __init__(self, backend: Backend, client: StateClient, wq: WorkQueue,
                 tpu: GpuScheduler, cpu: CpuScheduler, ports: PortScheduler,
                 version_map: VersionMap, merge_map: MergeMap,
                 intents: Optional[IntentJournal] = None,
                 events=None):
        # operation event log (replace.copied events); None in bare tests
        self.events = events
        self.backend = backend
        self.client = client
        self.wq = wq
        self.tpu = tpu
        self.cpu = cpu
        self.ports = ports
        self.versions = version_map
        self.merges = merge_map
        # intent journal: every multi-step mutation records begin/step/done
        # markers synchronously, so a control-plane crash leaves a durable
        # record of exactly what was in flight (reconcile.py replays them)
        self.intents = intents if intents is not None else IntentJournal(client)
        # one mutation at a time per replicaSet; the reference relies on
        # goroutine luck here (SURVEY §5.2)
        self._name_locks: dict[str, threading.Lock] = {}
        self._name_locks_guard = threading.Lock()
        # authoritative latest-info cache: persistence is write-behind, so a
        # read hot on the heels of a mutation must not depend on the queue
        # having drained (the reference reads etcd here and wins by luck)
        self._latest: dict[str, StoredContainerInfo] = {}
        # gang reshard counter (mesh-shape changes committed through the
        # rolling replace) — exported as tdapi_reshards_total
        self.reshards_total = 0
        # heterogeneity-aware placement hook (placement.FleetModel). None
        # = legacy first-fit through self.tpu.apply; the App wires it when
        # a placement policy is configured. Whole-chip grants then go
        # enumerate→score→claim; fractional grants and the fragmented
        # fallback stay on the mechanism layer.
        self.placer = None

    @contextlib.contextmanager
    def _mutex(self, name: str):
        """Hold the per-name mutation mutex. delete_container drops the
        table entry when a replicaSet is gone (the table used to grow one
        lock per name FOREVER); a waiter that acquires a lock which was
        dropped while it was blocked retries on the fresh entry, so two
        holders can never coexist. Only a holder may drop the entry, which
        is what makes the acquire-then-recheck race-free."""
        while True:
            with self._name_locks_guard:
                lock = self._name_locks.setdefault(name, threading.Lock())
            lock.acquire()
            with self._name_locks_guard:
                current = self._name_locks.get(name)
            if current is lock:
                break
            lock.release()   # entry dropped while we waited: retry fresh
        try:
            yield
        finally:
            lock.release()

    def _drop_mutex(self, name: str) -> None:
        """Forget a deleted replicaSet's lock entry. MUST be called while
        holding the name's mutex (see _mutex)."""
        with self._name_locks_guard:
            self._name_locks.pop(name, None)

    # ------------------------------------------------------------------ run

    @trace.traced("svc.run", "req.replicaSetName")
    def run_container(self, req: ContainerRun, clone_from: str = "",
                      share_avoid: Optional[set] = None,
                      idem_partial: bool = False) -> dict:
        """POST /replicaSet (reference RunGpuContainer, replicaset.go:45-155).

        clone_from: donor CONTAINER whose writable layer is CoW-cloned
        into the new container between create and start (gateway.py's
        autoscale fast path: the donor already paid model load / compile;
        the clone rides utils/copyfast's reflink ladder, so the new
        replica starts warm in ~milliseconds instead of re-initializing).
        Best-effort — a failed clone logs and cold-starts. share_avoid is
        the fractional placement's soft anti-affinity set (chips hosting
        sibling replicas). idem_partial marks this run as ONE piece of a
        larger keyed request (a gateway scale), so its intent completing
        never finalizes the request's idempotency record."""
        name = req.replicaSetName
        with self._mutex(name):
            if self.versions.exist(name) or self.backend.list_names(name + "-"):
                raise xerrors.ContainerExistedError(name)

            spec = ContainerSpec(
                image=req.imageName,
                env=list(req.env),
                cmd=list(req.cmd),
                binds=[b.format() for b in req.binds if b.format()],
                priority=req.priority,
            )
            if req.memory:
                spec.memory_bytes = to_bytes(req.memory)

            whole, quanta = parse_gpu_count(req.tpuCount)
            # gang plan: a non-trivial meshPlan makes this a plan-shaped
            # grant. An EXPLICITLY trivial plan on a 1-chip run still
            # stores + stamps (it pins the workload to a 1-device mesh —
            # the dp=1 leg of a reshard cycle); absent stays legacy.
            plan = PlanSpec.from_json(req.meshPlan)
            if not plan.is_trivial:
                plan.validate_count(req.tpuCount)
            store = stored_plan(plan, req.meshPlan, whole)
            meta = {"idemPartial": True} if idem_partial else {}
            intent = self.intents.begin("run", name, **meta)
            try:
                if quanta:
                    # fractional grant: `quanta`/SHARE_QUANTA of one chip —
                    # the chip is shared with co-tenants; the serving-path
                    # regulator time-slices it by this weight
                    self._grant_tpus(spec,
                                     [self.tpu.apply_shares(
                                         quanta, name, avoid=share_avoid)],
                                     shares=quanta)
                elif whole > 0:
                    # the declared profile persists on the spec so a later
                    # migrate/patch re-placement scores with it
                    spec.profile = dict(req.profile or {})
                    chips = None
                    if self.placer is not None:
                        self.placer.declare_profile(name, req.profile)
                        try:
                            _pool, chips = self.placer.place(
                                whole, name, plan=plan,
                                profile=req.profile)
                        except xerrors.GpuNotEnoughError:
                            if plan is not None and not plan.is_trivial:
                                raise
                            # no fully-free box anywhere: plan-less grants
                            # keep the mechanism layer's connected/
                            # fragmented fallback
                            chips = None
                    if chips is None:
                        chips = self.tpu.apply(whole, name, plan=plan)
                    self._grant_tpus(spec, chips, plan=store)
                if req.cpuCount > 0:
                    spec.cpuset = self.cpu.apply(req.cpuCount, name)
                    spec.cpu_count = req.cpuCount
                intent.step("granted", sync=False, tpuChips=spec.tpu_chips,
                            cpuset=spec.cpuset)
                crashpoint("run.after_grant")
                info = self._create_and_start(name, spec, req.containerPorts,
                                              intent=intent, cp="run",
                                              clone_from=clone_from)
            except Exception:
                # resource rollback on any failure (reference :103-124);
                # owner-checked so over-release is impossible. The unwind
                # completes here, so the intent closes; an InjectedCrash
                # (BaseException) skips both — exactly a daemon death.
                self._release_tpus(spec, name)
                self.cpu.restore(spec.cpuset, name)
                intent.done()
                raise
            intent.done(committed=True)
            return self._run_response(info)

    def _grant_tpus(self, spec: ContainerSpec, grant: list[int],
                    shares: int = 0,
                    plan: Optional[PlanSpec] = None) -> None:
        spec.tpu_chips = grant
        spec.tpu_shares = shares
        # the granted gang shape rides the spec (describe/history) AND the
        # container env (TDAPI_MESH_PLAN via env_for). plan=None = no
        # plan semantics: stores {} and stamps nothing, so legacy records
        # and fractional grants stay unchanged — the CALLER resolves
        # explicit-trivial (store + stamp, pinning a 1-device mesh) vs
        # absent (legacy auto-mesh).
        spec.mesh_plan = plan.to_json() if plan is not None else {}
        spec.tpu_env = self.tpu.env_for(grant, plan=plan) if grant else {}
        spec.devices = self.tpu.device_paths(grant)

    def _release_tpus(self, spec: ContainerSpec, name: str) -> None:
        """Return a spec's card grant — whole cards or the share ledger
        entry, depending on how it was granted. Owner-checked (and, for
        shares, exact-quanta) in the scheduler, so stale/duplicate
        releases can never free a co-tenant's capacity."""
        if spec.tpu_shares and spec.tpu_chips:
            self.tpu.restore_shares(spec.tpu_chips[0], spec.tpu_shares, name)
        else:
            self.tpu.restore(spec.tpu_chips, name)

    @staticmethod
    def _spec_tpu_count(spec: ContainerSpec) -> float:
        """A spec's grant expressed as the tpuCount that requested it
        (whole chips, or quanta/SHARE_QUANTA for a fractional grant)."""
        if spec.tpu_shares:
            return spec.tpu_shares / SHARE_QUANTA
        return len(spec.tpu_chips)

    def _create_and_start(self, name: str, spec: ContainerSpec,
                          container_ports: list[str],
                          start: bool = True,
                          intent: Optional[Intent] = None,
                          cp: str = "",
                          clone_from: str = "") -> StoredContainerInfo:
        """The runContainer core (reference replicaset_nomock.go:25-114):
        version bump -> port grant -> create -> [clone donor layer] ->
        start -> persist. `cp` namespaces the step-boundary crashpoints
        (run path only; the replace path places its own around this
        call). clone_from CoW-clones a donor container's writable layer
        into the fresh one before start (the gateway autoscale path) —
        best-effort: the cloned bytes are a warm-start accelerant, not
        state the control plane depends on, and they die with the
        container on any unwind exactly like pre-copied replace bytes."""
        version = self.versions.bump(name)
        ctr_name = f"{name}-{version}"
        port_grant: list[int] = []
        created = False
        try:
            if container_ports:
                port_grant = self.ports.apply(len(container_ports), name)
                spec.port_bindings = {
                    cp_: hp for cp_, hp in zip(container_ports, port_grant)}
            spec.env = [e for e in spec.env
                        if not e.startswith(("CONTAINER_VERSION=",
                                             "TDAPI_TPU_SHARES=",
                                             "TDAPI_PRIORITY="))]
            spec.env.append(f"CONTAINER_VERSION={version}")
            # multi-tenancy contract for the workload: its serving loop
            # registers with the per-chip regulator at this weight/class
            # (workloads/serve.py tenant_from_env)
            if spec.tpu_shares:
                spec.env.append(f"TDAPI_TPU_SHARES={spec.tpu_shares}")
            if spec.priority:
                spec.env.append(f"TDAPI_PRIORITY={spec.priority}")
            self.backend.create(ctr_name, spec)
            created = True
            if intent is not None:
                intent.step("created", container=ctr_name, version=version)
            if cp:
                crashpoint(f"{cp}.after_create")
            if clone_from:
                try:
                    from ..backend.base import copy_container_layer
                    stats = copy_container_layer(self.backend, clone_from,
                                                 ctr_name)
                except Exception:  # noqa: BLE001 — warm start is optional
                    log.exception("cloning %s layer into %s; starting cold",
                                  clone_from, ctr_name)
                    stats = None
                if intent is not None:
                    intent.step("cloned", sync=False, source=clone_from,
                                bytes=stats.bytes if stats else 0,
                                mode=stats.mode if stats else "none")
                crashpoint("gwscale.after_clone")
            if start:
                self.backend.start(ctr_name)
                if cp:
                    crashpoint(f"{cp}.after_start")
        except Exception:
            if created:
                # a created-but-failed container left behind would brick the
                # name: the next run re-mints the same version and collides
                try:
                    self.backend.remove(ctr_name, force=True)
                except Exception:  # noqa: BLE001
                    log.exception("removing failed container %s", ctr_name)
            self.ports.restore(port_grant, name)
            self.versions.rollback_bump(name, version - 1)
            raise

        info = StoredContainerInfo(
            version=version, createTime=_now(), containerName=ctr_name, spec=spec)
        self._persist_latest(name, info)
        if intent is not None:
            intent.step("persisted", sync=False, container=ctr_name,
                        version=version)
        return info

    def _persist_latest(self, name: str, info: StoredContainerInfo,
                        with_version_key: bool = True) -> None:
        payload = info.serialize()
        self._latest[name] = info
        self.wq.submit(PutKeyValue(CONTAINERS, name, payload))
        if with_version_key:
            v = info.version
            self.wq.submit(Call(
                lambda: self.client.put_entity_version(CONTAINERS, name, v, payload),
                describe=f"persist {CONTAINERS}/{name}@{v}"))

    # ---------------------------------------------------------------- patch

    @trace.traced("svc.patch", "name")
    def patch_container(self, name: str, req: PatchRequest,
                        if_match: Optional[int] = None) -> dict:
        """PATCH /replicaSet/{name} (reference PatchContainer :267-363).

        if_match: optional version precondition, checked under the name
        lock BEFORE any grant — a concurrent mutation that bumped the
        version makes this request lose with PreconditionFailedError
        (HTTP 412) instead of silently last-write-winning."""
        if req.empty:
            raise xerrors.NoPatchRequiredError(name)
        with self._mutex(name):
            old = self._stored_info(name)
            xerrors.PreconditionFailedError.check(name, old.version, if_match)
            new_spec = ContainerSpec.from_json(old.spec.to_json())
            changed = False
            # whether THIS patch took a fresh share grant — the release
            # decisions below must not infer it from spec (in)equality: a
            # fresh grant can legitimately land on the same chip with the
            # same quanta (see _rolling_replace)
            took_fresh = {"shares": False}
            intent = self.intents.begin(
                "replace", name, via="patch", oldVersion=old.version,
                oldContainer=old.containerName,
                oldReleased=old.resourcesReleased)
            try:
                if req.tpuPatch is not None:
                    changed |= self._patch_tpu(name, new_spec, old,
                                               req.tpuPatch.tpuCount,
                                               took_fresh=took_fresh,
                                               plan_json=req.tpuPatch.meshPlan)
                if req.cpuPatch is not None:
                    changed |= self._patch_cpu(name, new_spec, old,
                                               req.cpuPatch.cpuCount)
                if req.memoryPatch is not None:
                    changed |= self._patch_memory(new_spec, req.memoryPatch.memory)
                if req.volumePatch is not None:
                    changed |= self._patch_volume(new_spec, req.volumePatch)
                if not changed:
                    raise xerrors.NoPatchRequiredError(name)
                info = self._rolling_replace(
                    name, old, new_spec, intent,
                    fresh_shares=took_fresh["shares"])
            except Exception:
                self._free_new_grants(name, new_spec, old.spec,
                                      fresh_shares=took_fresh["shares"])
                intent.done()
                raise
            intent.done(committed=True)
            return self._run_response(info)

    def _patch_tpu(self, name: str, spec: ContainerSpec,
                   old: StoredContainerInfo, count: float,
                   took_fresh: Optional[dict] = None,
                   plan_json: Optional[dict] = None) -> bool:
        """Re-grant chips when the count OR the gang mesh plan changes
        (reference patchGpu :448-495) — in place: a whole-chip old grant
        is offered for reuse, never released to the pool mid-patch.
        Fractional targets take a FRESH share grant (preferring the chip
        already held, so an unchanged-chip resize stays put when capacity
        allows); the old holding is released only after the replace
        commits, and the ledger sums both during the window —
        capacity-checked, so the transition can never oversubscribe a
        co-tenant. took_fresh (when given) records that a fresh share
        grant now exists — the release paths key on it instead of
        comparing specs.

        plan_json: the patch's meshPlan. None = unspecified — an
        unchanged count keeps the stored plan, a count change resets a
        gang set to the trivial plan (the new chip count invalidates the
        old factors). An explicit dict (rollback passes the historical
        spec's, {} included) always wins. A plan or chip-set change on a
        gang set is a RESHARD: the grant is plan-shaped
        (reshard.after_grant is the crash boundary) and the replace that
        follows re-meshes the workload."""
        whole, quanta = parse_gpu_count(count)
        old_count = self._spec_tpu_count(old.spec)
        old_plan = PlanSpec.from_spec(old.spec.mesh_plan)
        if plan_json is not None:
            plan = PlanSpec.from_json(plan_json)
            if not plan.is_trivial:
                plan.validate_count(count)
        elif count == old_count:
            plan = old_plan
        else:
            plan = PlanSpec()
        if count == old_count and plan == old_plan:
            return False
        if quanta:
            prefer = (old.spec.tpu_chips[0]
                      if old.spec.tpu_shares and old.spec.tpu_chips else None)
            self._grant_tpus(spec, [self.tpu.apply_shares(
                quanta, name, prefer=prefer)], shares=quanta)
            if took_fresh is not None:
                took_fresh["shares"] = True
            return True
        reuse = (list(old.spec.tpu_chips)
                 if not old.resourcesReleased and not old.spec.tpu_shares
                 else [])
        self._grant_tpus(spec, self.tpu.apply(whole, name, reuse=reuse,
                                              plan=plan)
                         if whole > 0 else [],
                         plan=stored_plan(plan, plan_json, whole))
        if not plan.is_trivial or not old_plan.is_trivial:
            crashpoint("reshard.after_grant")
        return True

    def _patch_cpu(self, name: str, spec: ContainerSpec,
                   old: StoredContainerInfo, count: int) -> bool:
        old_count = old.spec.cpu_count or (
            len(old.spec.cpuset.split(",")) if old.spec.cpuset else 0)
        if count == old_count:
            return False
        reuse = old.spec.cpuset if not old.resourcesReleased else ""
        spec.cpuset = self.cpu.apply(count, name, reuse=reuse) if count > 0 else ""
        spec.cpu_count = count
        return True

    def _patch_memory(self, spec: ContainerSpec, memory: str) -> bool:
        new_bytes = to_bytes(memory)
        if new_bytes == spec.memory_bytes:
            return False
        spec.memory_bytes = new_bytes
        return True

    def _patch_volume(self, spec: ContainerSpec, vp) -> bool:
        if vp.oldBind is None or vp.newBind is None:
            return False
        old_s, new_s = vp.oldBind.format(), vp.newBind.format()
        if not old_s or not new_s or old_s == new_s:
            return False
        if old_s not in spec.binds:
            return False
        spec.binds = [new_s if b == old_s else b for b in spec.binds]
        return True

    def _free_new_grants(self, name: str, new_spec: ContainerSpec,
                         old_spec: ContainerSpec,
                         fresh_shares: bool = False) -> None:
        """Failed mutation: free only the grants that are NEW in new_spec.
        The old container's grants were never released (in-place reuse), so
        there is nothing to re-mark — and owner checks make this safe even
        if this unwind itself races."""
        if new_spec.tpu_shares:
            # a share grant is released only when the caller actually TOOK
            # a fresh one (fresh_shares) — a spec merely COPIED from a
            # fractional old (e.g. a failed memory patch) carries the same
            # chip+quanta without a grant behind it, so releasing it would
            # free live capacity. Spec comparison cannot tell the two
            # apart: a fresh grant may legitimately land on the same chip
            # with the same quanta (a drain racing an uncordon), and the
            # ledger then holds old+new — restore_shares' exact-quanta
            # release frees only the new half.
            if fresh_shares and new_spec.tpu_chips:
                self.tpu.restore_shares(new_spec.tpu_chips[0],
                                        new_spec.tpu_shares, name)
        else:
            new_tpu = sorted(set(new_spec.tpu_chips) - set(old_spec.tpu_chips))
            self.tpu.restore(new_tpu, name)
        old_cores = set(self.cpu._cores(old_spec.cpuset))
        new_cores = set(self.cpu._cores(new_spec.cpuset)) - old_cores
        self.cpu.restore(sorted(new_cores), name)

    # ------------------------------------------------------- rolling replace

    def _rolling_replace(self, name: str, old: StoredContainerInfo,
                         new_spec: ContainerSpec,
                         intent: Optional[Intent] = None,
                         meta_out: Optional[dict] = None,
                         fresh_shares: bool = False) -> StoredContainerInfo:
        """create new version -> pre-copy writable layer (old still
        running) -> QUIESCE the workload (checkpoint-now, bounded) -> stop
        old (chip exclusivity) -> delta-copy dirtied files (now including
        the quiesce checkpoint) -> start new -> delete old (reference
        :318-353, reordered).

        The quiesce step is the zero-loss half of training migration: a
        workload that opted in (spec env TDAPI_QUIESCE=1, handler wired in
        train.py) checkpoints its EXACT current step and parks before the
        stop, so the restarted version resumes with no replayed work. It
        is strictly best-effort — timeout, error, or an un-acked signal
        all fall back to today's plain stop (≤ checkpoint-every steps
        replayed), and a crash at any point reconciles exactly like an
        interrupted replace: the QUIESCED marker is idempotent, an
        unwound new container restarts the old one, which resumes from
        the same checkpoint. meta_out (when given) receives the
        per-migration quiesced/stepsLost outcome for the drain response.

        The pre-copy/delta split (utils/copyfast.py) moves the O(layer
        bytes) copy OUT of the stop->start downtime window: only the files
        dirtied between the warm copy and the stop move while the chips
        sit idle, so the window is O(dirty set). TDAPI_PRECOPY=0 restores
        the seed's single in-window copy. Crash/unwind semantics are
        unchanged: pre-copied files live in the new container's layer and
        vanish with it on unwind, and the reconciler's replay of a missing
        'copied' step is a full (idempotent) sync — clone plus
        symlink-protected delete — over whatever the pre-copy left behind.

        On success, resources held by the old version and not reused by the
        new one are freed. On failure, the world is restored: new container
        removed, new-only grants freed by the caller, version counter and
        latest pointer reverted, old container restarted.
        """
        from ..backend.base import precopy_container_layer
        from ..utils import copyfast
        old_holds = not old.resourcesReleased
        old_ports = list(old.spec.port_bindings.values())
        # gang reshard: a mesh-shape or chip-set change on a replicaSet
        # that carries (or carried) a non-trivial MeshPlan. The replace
        # machinery is identical — quiesce-checkpoint, stop, delta, start
        # — but the restarted workload re-meshes under the NEW plan, so
        # the transition gets its own crash boundary, intent marker, and
        # event (the SURVEY's dp=1 -> 4 -> 1 scenario).
        reshard = bool(
            (old.spec.mesh_plan or new_spec.mesh_plan)
            and (old.spec.mesh_plan != new_spec.mesh_plan
                 or sorted(old.spec.tpu_chips) != sorted(new_spec.tpu_chips)))
        container_ports = list(new_spec.port_bindings.keys())
        new_spec.port_bindings = {}
        info = self._create_and_start(name, new_spec, container_ports,
                                      start=False, intent=intent)
        crashpoint("replace.after_create")
        old_state = self.backend.inspect(old.containerName)
        pre_snap = pre_stats = None
        downtime_ms = None
        quiesced = False
        quiesce_step = None
        try:
            if copyfast.precopy_enabled():
                try:
                    pre = precopy_container_layer(
                        self.backend, old.containerName, info.containerName)
                except Exception:  # noqa: BLE001 — warm copy is best-effort;
                    log.exception("pre-copy %s -> %s; falling back to "
                                  "in-window copy", old.containerName,
                                  info.containerName)
                    pre = None     # the in-window full copy still runs
                if pre is not None:
                    pre_snap, pre_stats = pre
                    if intent is not None:
                        intent.step("precopied", sync=False,
                                    bytes=pre_stats.bytes,
                                    files=pre_stats.files,
                                    mode=pre_stats.mode)
            # workload quiesce: after the warm copy (training continued
            # through it), while the old container still runs and holds
            # its chips, ask the workload to checkpoint-now and park. The
            # checkpoint it writes dirties files AFTER the pre-copy
            # snapshot, so the delta pass below carries the now-final
            # checkpoint dir inside the stop->start window — O(checkpoint)
            # not O(layer). Bounded and best-effort: never wedge a drain.
            if (quiesce_enabled() and spec_wants_quiesce(old.spec)
                    and old_state.exists and old_state.running):
                try:
                    quiesced = self.backend.quiesce(
                        old.containerName, timeout=quiesce_timeout())
                except Exception:  # noqa: BLE001 — fall back to plain stop
                    log.exception("quiesce %s failed; falling back to "
                                  "plain stop", old.containerName)
                    quiesced = False
                if quiesced and old_state.upper_dir:
                    quiesce_step = _read_quiesce_ack(old_state.upper_dir)
            if intent is not None:
                # informational (sync=False): the reconciler's replay
                # branches don't consult it — recovery is identical to any
                # interrupted replace because the checkpoint + QUIESCED
                # marker are idempotent workload state, not control-plane
                # state
                intent.step("quiesced", sync=False, ok=quiesced,
                            step=quiesce_step)
            crashpoint("replace.after_quiesce")
            if reshard:
                # informational like "quiesced": replay branches on the
                # stored record alone — the marker documents WHAT shape
                # change was in flight for the operator reading the journal
                if intent is not None:
                    intent.step("resharded", sync=False,
                                fromPlan=old.spec.mesh_plan or {},
                                toPlan=new_spec.mesh_plan or {},
                                fromChips=sorted(old.spec.tpu_chips),
                                toChips=sorted(new_spec.tpu_chips))
                crashpoint("reshard.after_quiesce")
            t_window = time.perf_counter()
            if old_state.exists and (old_state.running or old_state.paused):
                self.backend.stop(old.containerName)
            if intent is not None:
                intent.step("stopped_old", sync=False)
            crashpoint("replace.after_stop_old")
            copy_stats = self._copy_layer(old.containerName,
                                          info.containerName,
                                          snapshot=pre_snap)
            if intent is not None:
                intent.step("copied")
            crashpoint("replace.after_copy")
            self.backend.start(info.containerName)
            downtime_ms = (time.perf_counter() - t_window) * 1e3
            copyfast.METRICS.observe_downtime(downtime_ms)
            if intent is not None:
                intent.step("started_new", sync=False)
            crashpoint("replace.after_start_new")
        except Exception:
            # failed mid-replace: remove the new container, revert latest
            # pointer + version counter + per-version key, restart the old
            try:
                self.backend.remove(info.containerName, force=True)
            except Exception:  # noqa: BLE001
                log.exception("cleanup: removing failed new container")
            self.ports.restore(list(info.spec.port_bindings.values()), name)
            self.versions.rollback_bump(name, old.version)
            self._persist_latest(name, old, with_version_key=False)
            v = info.version
            self.wq.submit(Call(
                lambda: self.client.delete_entity_version(CONTAINERS, name, v),
                describe=f"drop {CONTAINERS}/{name}@{v}"))
            if old_state.exists and old_state.running:
                try:
                    self.backend.start(old.containerName)
                except Exception:  # noqa: BLE001
                    log.exception("cleanup: restarting old container")
            raise
        if meta_out is not None:
            meta_out["quiesced"] = quiesced
            # quiesced => the checkpoint sits at the exact parked step:
            # zero replayed steps by construction. Fallback => unknown to
            # the control plane (bounded by the workload's
            # --checkpoint-every), reported honestly as null.
            meta_out["stepsLost"] = 0 if quiesced else None
        if self.events is not None:
            self.events.record(
                "replace.copied", target=name,
                quiesced=quiesced, quiesceStep=quiesce_step,
                precopied=pre_snap is not None,
                precopyBytes=pre_stats.bytes if pre_stats else 0,
                windowBytes=copy_stats.bytes if copy_stats else 0,
                deltaFiles=copy_stats.delta_files if copy_stats else 0,
                # report the rung that actually moved bytes: an empty delta
                # pass never exercises its ladder, so its mode is noise
                mode=(copy_stats.mode if copy_stats and copy_stats.files
                      else pre_stats.mode if pre_stats
                      else copy_stats.mode if copy_stats else "none"),
                copySeconds=round(
                    (pre_stats.seconds if pre_stats else 0.0)
                    + (copy_stats.seconds if copy_stats else 0.0), 6),
                downtimeMs=round(downtime_ms, 3))
        if reshard:
            self.reshards_total += 1
            if self.events is not None:
                self.events.record(
                    "reshard", target=name,
                    fromPlan=old.spec.mesh_plan or {},
                    toPlan=new_spec.mesh_plan or {},
                    fromChips=sorted(old.spec.tpu_chips),
                    toChips=sorted(new_spec.tpu_chips),
                    quiesced=quiesced, quiesceStep=quiesce_step)
        self._record_merge(name, info.containerName)
        # delete-old-for-update (reference :660-679): drop it, free the old
        # version's resources that the new version did not take over — only
        # if the old version still held them (not already released by stop)
        try:
            self.backend.remove(old.containerName, force=True)
        except Exception:  # noqa: BLE001
            log.exception("removing replaced container %s", old.containerName)
        if intent is not None:
            intent.step("removed_old", sync=False)
        crashpoint("replace.after_remove_old")
        if old_holds:
            if old.spec.tpu_shares:
                # fractional old grant: release its exact quanta — unless
                # the new version carried the identical holding over
                # untouched (e.g. a memory patch copied the spec; no fresh
                # share grant exists, so a release here would free live
                # capacity under the new container). fresh_shares is the
                # caller's explicit word that a fresh grant DOES back the
                # new spec — spec equality cannot stand in for it: a drain
                # whose re-grant lands on the same chip with the same
                # quanta (the cordon raced an uncordon) would read as
                # "identical carryover" and leak the old holding forever.
                if (fresh_shares or not new_spec.tpu_shares
                        or new_spec.tpu_chips != old.spec.tpu_chips):
                    self.tpu.restore_shares(old.spec.tpu_chips[0],
                                            old.spec.tpu_shares, name)
            else:
                stale_tpu = sorted(set(old.spec.tpu_chips) -
                                   set(new_spec.tpu_chips)
                                   if not new_spec.tpu_shares
                                   else set(old.spec.tpu_chips))
                self.tpu.restore(stale_tpu, name)
            stale_cores = sorted(set(self.cpu._cores(old.spec.cpuset)) -
                                 set(self.cpu._cores(new_spec.cpuset)))
            self.cpu.restore(stale_cores, name)
            self.ports.restore(old_ports, name)
        return info

    def _copy_layer(self, old_name: str, new_name: str, snapshot=None):
        """Carry the writable layer forward (shared with the crash
        reconciler's replay of this step — backend/base.py). With a
        pre-copy snapshot this is the delta pass; without, a full clone.
        Returns the CopyStats (or None when layer dirs are unavailable)."""
        from ..backend.base import copy_container_layer
        return copy_container_layer(self.backend, old_name, new_name,
                                    snapshot=snapshot)

    def _record_merge(self, name: str, ctr_name: str) -> None:
        """Track the merged-layer path per version (reference setToMergeMap,
        replicaset.go:681-704)."""
        state = self.backend.inspect(ctr_name)
        if state.upper_dir:
            self.merges.set(ctr_name, state.upper_dir)

    # ------------------------------------------------------------- rollback

    @trace.traced("svc.rollback", "name")
    def rollback_container(self, name: str, version: int,
                           if_match: Optional[int] = None) -> dict:
        """PATCH /replicaSet/{name}/rollback (reference :365-446): forward-
        write a new version with the historical config. if_match guards
        the CURRENT version (the one being rolled away from)."""
        with self._mutex(name):
            current = self.versions.get(name)
            if current is None:
                raise xerrors.NotExistInStoreError(name)
            xerrors.PreconditionFailedError.check(name, current, if_match)
            if current == version:
                raise xerrors.NoRollbackRequiredError(name)
            self.wq.join()  # per-version keys are write-behind; drain first
            hist = StoredContainerInfo.deserialize(
                self.client.get_entity_version(CONTAINERS, name, version))
            old = self._stored_info(name)
            target_spec = ContainerSpec.from_json(hist.spec.to_json())
            # resource identities are NOT part of history — keep the grants
            # the replicaSet holds NOW, re-granting (with in-place reuse)
            # only where the historical COUNT differs
            target_spec.tpu_chips = old.spec.tpu_chips
            target_spec.tpu_shares = old.spec.tpu_shares
            target_spec.tpu_env = old.spec.tpu_env
            target_spec.devices = old.spec.devices
            target_spec.cpuset = old.spec.cpuset
            target_spec.cpu_count = old.spec.cpu_count
            intent = self.intents.begin(
                "replace", name, via="rollback", oldVersion=old.version,
                oldContainer=old.containerName, targetVersion=version,
                oldReleased=old.resourcesReleased)
            took_fresh = {"shares": False}
            try:
                # the historical plan is part of the rolled-back-to config:
                # pass it EXPLICITLY ({} for a pre-gang version) so a
                # rollback across a reshard restores the old mesh shape,
                # not just the old chip count
                self._patch_tpu(name, target_spec, old,
                                self._spec_tpu_count(hist.spec),
                                took_fresh=took_fresh,
                                plan_json=hist.spec.mesh_plan or {})
                self._patch_cpu(name, target_spec, old, hist.spec.cpu_count)
                intent.step("granted", sync=False, tpuChips=target_spec.tpu_chips,
                            cpuset=target_spec.cpuset)
                crashpoint("rollback.after_grant")
                info = self._rolling_replace(
                    name, old, target_spec, intent,
                    fresh_shares=took_fresh["shares"])
            except Exception:
                self._free_new_grants(name, target_spec, old.spec,
                                      fresh_shares=took_fresh["shares"])
                intent.done()
                raise
            intent.done(committed=True)
            return self._run_response(info)

    # ---------------------------------------------------------------- drain

    @trace.traced("svc.drain")
    def drain_cordoned(self) -> dict:
        """POST /tpus/drain: migrate every stored replicaSet holding a
        cordoned chip onto healthy chips through the rolling-replace path.

        Each migration is an ordinary replace (via="drain") — journaled
        through the intent journal, so a crash mid-drain reconciles like
        any other interrupted replace. Training workloads that opted into
        the quiesce contract are checkpointed at their exact step before
        the move (zero-loss; per-item quiesced/stepsLost report it). The
        re-grant offers the old chips for in-place reuse; apply() itself
        filters cordoned chips out of both the free pool and the reuse
        set, so the new placement keeps healthy chips where it can and
        never re-grants a cordoned one. Failures (e.g. not enough healthy
        capacity) are reported per replicaSet and do not abort the rest
        of the drain — and a re-POST is idempotent: already-migrated sets
        no longer hold cordoned chips and are passed over, failed ones
        are retried."""
        cordoned = self.tpu.cordoned_snapshot()
        result: dict = {"cordoned": sorted(cordoned), "drained": [],
                        "skipped": [], "failed": {}}
        if not cordoned:
            return result
        self.wq.join()      # the stored-record scan must see queued writes
        names = sorted({kv.key.rsplit("/", 1)[1]
                        for kv in self.client.range(CONTAINERS)})
        for name in names:
            with self._mutex(name):
                try:
                    old = self._stored_info(name)
                except xerrors.NotExistInStoreError:
                    continue
                if not set(old.spec.tpu_chips) & cordoned:
                    continue
                if old.resourcesReleased:
                    # stopped: holds no grant; its next restart re-applies
                    # fresh counts, which already exclude cordoned chips
                    result["skipped"].append(name)
                    continue
                try:
                    item = self._migrate_locked(name, old, via="drain")
                except xerrors.BackendUnavailableError:
                    # breaker open: the WHOLE substrate is refusing — abort
                    # the drain (503 to the caller) instead of logging one
                    # doomed migration per replicaSet
                    raise
                except Exception as e:  # noqa: BLE001 — drain the rest
                    log.exception("drain: migrating %s failed", name)
                    result["failed"][name] = str(e)
                    continue
                result["drained"].append(item)
        return result

    def _migrate_locked(self, name: str, old: StoredContainerInfo,
                        via: str, avoid: Optional[set] = None) -> dict:
        """One journaled live migration through the rolling-replace
        ladder — the shared mechanism under drain (via="drain": cordoned
        chips are already invisible to the scheduler) and the
        defragmenter (via="defrag": `avoid` carries the box being
        opened, a HARD exclusion on the re-grant so the eviction cannot
        land back inside it). Caller holds self._mutex(name) and has
        loaded `old`. Returns the migration report item; on failure
        unwinds fresh grants, closes the intent, and re-raises.

        idemPartial: one drain/defrag request journals one intent PER
        replicaSet, so no single intent's completion means the REQUEST
        completed — a crash mid-sweep must re-execute the keyed retry
        (a re-POST skips already-migrated sets), never finalize the key
        as a fabricated full success."""
        avoid = set(avoid or ())
        new_spec = ContainerSpec.from_json(old.spec.to_json())
        intent = self.intents.begin(
            "replace", name, via=via, oldVersion=old.version,
            oldContainer=old.containerName,
            oldReleased=old.resourcesReleased, idemPartial=True)
        migration_meta: dict = {}
        fresh = False
        try:
            if old.spec.tpu_shares:
                # fractional co-tenant: fresh share grant (apply_shares
                # excludes cordoned chips; a defrag avoid set is strict —
                # failing beats re-granting inside the box being opened);
                # its exact old quanta release when the replace commits —
                # zero leaked shares per migrated co-tenant. The grant is
                # fresh even if it lands back on the SAME chip (a drain's
                # cordon snapshot may have raced an uncordon) —
                # fresh_shares tells the release paths so. Set AFTER
                # apply_shares: a failed grant must leave fresh False, or
                # the unwind would release the live old holding the
                # copied spec still names.
                self._grant_tpus(new_spec, [self.tpu.apply_shares(
                    old.spec.tpu_shares, name,
                    avoid=avoid or None, strict_avoid=bool(avoid))],
                    shares=old.spec.tpu_shares)
                fresh = True
            else:
                # a gang set migrates as a gang: the re-grant is
                # plan-shaped (apply excludes cordoned + avoided chips
                # from pool and reuse alike); plan-less stays plan-less
                mig_plan = (PlanSpec.from_spec(old.spec.mesh_plan)
                            if old.spec.mesh_plan else None)
                self._grant_tpus(new_spec, self.tpu.apply(
                    len(old.spec.tpu_chips), name,
                    reuse=list(old.spec.tpu_chips), plan=mig_plan,
                    avoid=avoid or None),
                    plan=mig_plan)
            intent.step("granted", sync=False, tpuChips=new_spec.tpu_chips)
            info = self._rolling_replace(name, old, new_spec, intent,
                                         meta_out=migration_meta,
                                         fresh_shares=fresh)
        except Exception:
            self._free_new_grants(name, new_spec, old.spec,
                                  fresh_shares=fresh)
            intent.done()
            raise
        intent.done()
        return {
            "name": name, "version": info.version,
            "fromChips": sorted(old.spec.tpu_chips),
            "toChips": sorted(info.spec.tpu_chips),
            # zero-loss contract surface: quiesced=True means the
            # workload checkpointed its exact step before the move
            # (stepsLost 0); False means plain stop-and-replay
            # (stepsLost null — bounded by its checkpoint cadence)
            "quiesced": migration_meta.get("quiesced", False),
            "stepsLost": migration_meta.get("stepsLost")}

    def migrate_replicaset(self, name: str, via: str = "defrag",
                           avoid: Optional[set] = None) -> dict:
        """Migrate ONE stored replicaSet off the `avoid` chips — the
        defragmenter's eviction primitive, journaled exactly like a
        drain migration. A stopped set (resources already released)
        holds no chips and returns a no-op item; unknown names raise
        NotExistInStoreError."""
        with self._mutex(name):
            old = self._stored_info(name)
            if old.resourcesReleased:
                return {"name": name, "version": old.version,
                        "fromChips": [], "toChips": [],
                        "quiesced": False, "stepsLost": None,
                        "skipped": "resourcesReleased"}
            return self._migrate_locked(name, old, via=via, avoid=avoid)

    # ---------------------------------------------------- stop / restart etc

    @trace.traced("svc.stop", "name")
    def stop_container(self, name: str,
                       if_match: Optional[int] = None) -> None:
        """PATCH /replicaSet/{name}/stop (reference :582-639): resources are
        released; container stays stopped. Idempotent: the release is
        recorded, so a second stop cannot double-free (reference bug —
        replicaset.go:630-635 Restores again on its error path)."""
        with self._mutex(name):
            info = self._stored_info(name)
            xerrors.PreconditionFailedError.check(name, info.version, if_match)
            intent = self.intents.begin("stop", name,
                                        container=info.containerName,
                                        released=info.resourcesReleased)
            try:
                self.backend.stop(info.containerName)
                intent.step("stopped", sync=False)
                crashpoint("stop.after_backend_stop")
                if info.resourcesReleased:
                    intent.done(committed=True)
                    return
                spec = info.spec
                self._release_tpus(spec, name)
                self.cpu.restore(spec.cpuset, name)
                self.ports.restore(list(spec.port_bindings.values()), name)
                intent.step("restored", sync=False)
                crashpoint("stop.after_restore")
                info.resourcesReleased = True
                self._persist_latest(name, info, with_version_key=False)
            except Exception:
                intent.done()
                raise
            intent.done(committed=True)

    @trace.traced("svc.restart", "name")
    def restart_container(self, name: str,
                          if_match: Optional[int] = None) -> dict:
        """PATCH /replicaSet/{name}/restart (reference :736-864): a restart
        is a NEW VERSION with freshly applied resources, not docker restart."""
        with self._mutex(name):
            old = self._stored_info(name)
            xerrors.PreconditionFailedError.check(name, old.version, if_match)
            new_spec = ContainerSpec.from_json(old.spec.to_json())
            fresh_tpu: list[int] = []
            fresh_shares = 0
            fresh_cpu = ""
            intent = self.intents.begin(
                "replace", name, via="restart", oldVersion=old.version,
                oldContainer=old.containerName,
                oldReleased=old.resourcesReleased)
            try:
                if old.resourcesReleased:
                    # stopped: grants were returned at stop; re-apply counts
                    if old.spec.tpu_shares:
                        # fresh_shares is set only once the grant EXISTS:
                        # apply_shares raising (capacity gone since the
                        # stop) must leave the unwind below with nothing
                        # to free — keying it on the requested quanta made
                        # the handler index an empty fresh_tpu (the stress
                        # sweep's worker IndexError)
                        fresh_tpu = [self.tpu.apply_shares(
                            old.spec.tpu_shares, name)]
                        fresh_shares = old.spec.tpu_shares
                        self._grant_tpus(new_spec, fresh_tpu,
                                         shares=fresh_shares)
                    elif old.spec.tpu_chips:
                        # gang spec: the fresh grant must be plan-shaped
                        # too (and keep stamping TDAPI_MESH_PLAN); a
                        # plan-less spec stays plan-less
                        rs_plan = (PlanSpec.from_spec(old.spec.mesh_plan)
                                   if old.spec.mesh_plan else None)
                        fresh_tpu = self.tpu.apply(len(old.spec.tpu_chips),
                                                   name, plan=rs_plan)
                        self._grant_tpus(new_spec, fresh_tpu, plan=rs_plan)
                    if old.spec.cpu_count:
                        fresh_cpu = self.cpu.apply(old.spec.cpu_count, name)
                        new_spec.cpuset = fresh_cpu
                intent.step("granted", sync=False, tpuChips=new_spec.tpu_chips,
                            cpuset=new_spec.cpuset)
                crashpoint("restart.after_grant")
                # running: keep the identical grant — same host, same ICI
                # region, nothing to move (reference Restore-then-Apply
                # churn, :783-808, buys nothing on a single host)
                info = self._rolling_replace(name, old, new_spec, intent)
            except Exception:
                # free only what THIS restart freshly applied
                if fresh_shares and fresh_tpu:
                    self.tpu.restore_shares(fresh_tpu[0], fresh_shares, name)
                else:
                    self.tpu.restore(fresh_tpu, name)
                self.cpu.restore(fresh_cpu, name)
                intent.done()
                raise
            intent.done(committed=True)
            return self._run_response(info)

    @trace.traced("svc.pause", "name")
    def pause_container(self, name: str) -> None:
        info = self._stored_info(name)
        self.backend.pause(info.containerName)

    @trace.traced("svc.continue", "name")
    def startup_container(self, name: str) -> None:
        """PATCH /replicaSet/{name}/continue (reference StartupContainer
        :717-732 — `docker restart`, pause's dual)."""
        info = self._stored_info(name)
        self.backend.restart_inplace(info.containerName)

    # -------------------------------------------------- exec / commit / info

    @trace.traced("svc.execute", "name")
    def execute_container(self, name: str, cmd: list[str],
                          workdir: str = "") -> str:
        """POST /replicaSet/{name}/execute (reference :225-265)."""
        info = self._stored_info(name)
        code, output = self.backend.execute(info.containerName, cmd, workdir)
        if code != 0:
            raise RuntimeError(f"exec exit {code}: {output.strip()}")
        return output

    @trace.traced("svc.commit", "name")
    def commit_container(self, name: str, new_image: str) -> str:
        info = self._stored_info(name)
        return self.backend.commit(info.containerName, new_image)

    def get_container_info(self, name: str) -> dict:
        info = self._stored_info(name)
        try:
            state = self.backend.inspect(info.containerName)
            running, paused, degraded = state.running, state.paused, False
        except xerrors.BackendUnavailableError:
            # degraded read-only mode: the breaker is refusing substrate
            # calls, but the MVCC store still knows everything except live
            # run-state — answer from it rather than 503 a read
            running = paused = None
            degraded = True
        out = {
            "version": info.version,
            "createTime": info.createTime,
            "containerName": info.containerName,
            "running": running,
            "paused": paused,
            "resourcesReleased": info.resourcesReleased,
            "meshPlan": PlanSpec.from_spec(info.spec.mesh_plan).to_json(),
            "spec": info.spec.to_json(),
        }
        if degraded:
            out["degraded"] = True
        # per-worker launch plan when the grant spans TPU VM hosts: the env
        # each worker's container needs so the libtpu processes form ONE
        # slice (SURVEY §5.8 — multi-host over the same REST surface)
        topo = self.tpu.topology
        chips = info.spec.tpu_chips
        if chips and len(topo.workers_spanned(chips)) > 1:
            out["multihost"] = {
                str(w): env for w, env in topo.multihost_env(
                    chips, plan=info.spec.mesh_plan or None).items()}
        return out

    def get_container_history(self, name: str) -> list[dict]:
        """Reference GetContainerHistory (:908) — newest first."""
        self.wq.join()  # history reads the store; drain write-behind first
        versions = self.client.entity_versions(CONTAINERS, name)
        if not versions:
            raise xerrors.NotExistInStoreError(name)
        out = []
        for v, payload in reversed(versions):
            info = StoredContainerInfo.deserialize(payload)
            out.append(HistoryItem(v, info.createTime, info).to_json())
        return out

    # --------------------------------------------------------------- delete

    @trace.traced("svc.delete", "name")
    def delete_container(self, name: str,
                         if_match: Optional[int] = None) -> None:
        """DELETE /replicaSet/{name} (reference :157-223): remove container,
        release resources, drop ALL state + history. Resources are released
        whenever this replicaSet still holds them — including containers
        that exited on their own (the reference leaks those; its release is
        keyed on running-state, not grant-state)."""
        with self._mutex(name):
            try:
                info = self._stored_info(name)
            except xerrors.NotExistInStoreError:
                info = None
            xerrors.PreconditionFailedError.check(
                name, info.version if info else 0, if_match)
            intent = self.intents.begin(
                "delete", name,
                container=info.containerName if info else "",
                released=info.resourcesReleased if info else True)
            try:
                if info is not None:
                    state = self.backend.inspect(info.containerName)
                    if state.exists:
                        self.backend.remove(info.containerName, force=True)
                    intent.step("removed", sync=False)
                    crashpoint("delete.after_remove")
                    if not info.resourcesReleased:
                        spec = info.spec
                        self._release_tpus(spec, name)
                        self.cpu.restore(spec.cpuset, name)
                        self.ports.restore(list(spec.port_bindings.values()), name)
                    intent.step("restored", sync=False)
                    crashpoint("delete.after_restore")
                self._latest.pop(name, None)
                self.versions.remove(name)
                self.merges.remove_replicaset(name)
                self.wq.join()  # drain queued writes before deleting the keys
                self.client.delete(CONTAINERS, name)
                self.client.delete_entity_versions(CONTAINERS, name)
            except Exception:
                intent.done()
                raise
            intent.done(committed=True)
            # the name is gone: drop its mutex entry (unbounded-growth fix;
            # safe here because we still hold the lock — see _mutex)
            self._drop_mutex(name)

    # -------------------------------------------------------------- helpers

    def _stored_info(self, name: str) -> StoredContainerInfo:
        cached = self._latest.get(name)
        if cached is not None:
            return cached
        info = StoredContainerInfo.deserialize(self.client.get_value(CONTAINERS, name))
        self._latest[name] = info
        return info

    def invalidate(self, name: str) -> None:
        """Drop the latest-info cache entry — the reconciler rewrites
        stored records out-of-band and must not leave a stale cache."""
        self._latest.pop(name, None)

    @staticmethod
    def _run_response(info: StoredContainerInfo) -> dict:
        return {
            "name": info.containerName,
            "version": info.version,
            "tpuChips": info.spec.tpu_chips,
            # fractional multi-tenancy surface: quanta held on tpuChips[0]
            # (0 = whole-chip grant) and the regulator priority class
            "tpuShares": info.spec.tpu_shares,
            "priority": info.spec.priority,
            # the granted gang shape as a FULL axis dict (trivial for
            # non-gang sets) — what a client resharding via PATCH reads
            "meshPlan": PlanSpec.from_spec(info.spec.mesh_plan).to_json(),
            "cpuset": info.spec.cpuset,
            "portBindings": info.spec.port_bindings,
        }
