"""Boot-time reconciler: make world state match stored state after a crash.

The control plane's multi-step mutations (services/replicaset.py,
services/volume.py) are not atomic: a daemon crash mid-operation can leave
granted chips with no container, containers the store has never heard of,
half-replaced versions, or a stop whose release flag never persisted. The
reference control plane simply leaks all of it (PAPER.md / SURVEY §2); here
App runs a Reconciler pass on every boot, after the schedulers load their
persisted state and before the API starts serving.

Pass order (each pass is idempotent; a second run right after the first
must report zero actions):

1. **Intent replay** — every open intent (intents.py) is completed or
   unwound. The stored `containers/{name}` / `volumes/{name}` record is
   the authority: if the crash happened after the new state was persisted
   the operation is rolled FORWARD (finish the layer copy, complete the
   stop's release, finish the delete); if it died before, the partial
   side effects are unwound (orphan container removed, version counter
   reverted). Replay happens first so the later cross-checks see a world
   whose in-flight operations are settled.
2. **Grant cross-check** — the three scheduler bitmaps are diffed against
   the grants recorded in stored container specs: grants owned by a name
   that the store doesn't back are freed (owner-checked restore, so a
   live grant can never be stolen), and recorded grants that the bitmap
   lost are re-marked.
3. **Container cross-check** — backend containers the store doesn't own
   are force-removed; stored containers the backend lost are recreated
   (and started when their grants are held); created-but-never-started
   ones are started. Everything alive and owned is adopted as-is (the
   process substrate's supervisor watches whatever is in its table, so
   adoption re-arms supervision automatically).
4. **Version normalization** — version counters are raised to at least
   the stored version, counters without a stored record are dropped, and
   per-version history keys newer than the live version are deleted.
5. **Volume cross-check** — backend volumes whose base name is unknown to
   the store (no record, no version counter, no history keys) are
   removed. Known-but-missing volumes are NOT recreated: their data is
   gone and `?noall` history-keeping deletes legitimately leave records
   without backing volumes.
6. **Dead-letter replay** — WorkQueue.replay_dropped() re-queues writes
   that exhausted their retries.

The result is a report dict (also emitted to the EventLog and served at
GET /api/v1/reconcile) whose "actions" total is the no-op indicator.

The port's copy of the JAX control plane's reconcile.py.
"""

from __future__ import annotations

import logging
import re
from typing import Optional

from .backend.base import copy_container_layer
from .dtos import StoredContainerInfo, StoredVolumeInfo
from .intents import IntentRecord
from .obs import trace as obs_trace
from .utils.copyfast import move_dir_contents

log = logging.getLogger(__name__)

CONTAINERS = "containers"
VOLUMES = "volumes"

# this control plane's naming: a dashless base name (the API rejects dashes
# in replicaSet and volume names) + "-" + numeric version. Orphan sweeps
# only ever touch names of this shape — on a SHARED substrate (a dockerd
# that also runs other workloads) everything else is not ours to remove.
_MANAGED_NAME = re.compile(r"[^-]+-\d+$")

# ---- intent-journal registry (enforced by tdlint's unknown-step rule) ----
# Every step name the services may write MUST appear below, or a linted
# build fails: a step the reconciler has never heard of would otherwise be
# silently skipped at boot — the drift lands exactly when a crash needs it.

#: steps the replay branches actually READ (has_step/step_meta); these are
#: written synchronously by the services (intents.Intent.step sync=True)
CONSULTED_STEPS = frozenset({"created", "copied", "migrated"})

#: steps recorded for observability only (sync=False journal slimming);
#: replay never branches on them, but they are registered so the linter
#: can tell "known informational" from "forgot to teach the reconciler".
#: "cloned" (a gateway scale-up's donor-layer CoW clone) and the
#: gateway.scale markers are informational by the same argument as
#: "precopied": cloned bytes live in the new container's layer and die
#: with it on unwind, so replay branches on the stored record alone.
#: "resharded" (a gang replace's mesh-shape change) is informational for
#: the same reason "quiesced" is: the plan lives in the stored spec (and
#: its env), so replay of the surrounding replace already lands the right
#: shape — the marker documents the in-flight transition for operators.
INFORMATIONAL_STEPS = frozenset({
    "granted", "persisted", "precopied", "quiesced", "resharded",
    "stopped_old", "started_new", "removed_old", "stopped", "restored",
    "removed", "cloned", "replica_started", "replica_stopped",
    # federation lease crashpoints (federation.py FleetMember): a member
    # that died between the arbiter persisting a grant and recording its
    # own belief leaves NO intent step — the grant table is the truth
    # and the next heartbeat re-derives belief from it. Registered here
    # so a fed-adjacent intent journaling them never trips the
    # unknown-step alarm.
    "fed.after_acquire", "fed.after_takeover",
    # defrag umbrella intent (defrag.py): "planned" records the chosen
    # box + eviction list for operators; replay branches on nothing —
    # the per-tenant replace intents carry the real recovery and the
    # next run re-diagnoses live state
    "planned",
})

KNOWN_STEPS = CONSULTED_STEPS | INFORMATIONAL_STEPS


class Reconciler:
    def __init__(self, backend, client, wq, tpu, cpu, ports,
                 container_versions, volume_versions, merges, intents,
                 events=None, replicasets=None, volumes=None,
                 idempotency=None, traces=None):
        self.backend = backend
        self.client = client
        self.wq = wq
        self.tpu = tpu
        self.cpu = cpu
        self.ports = ports
        self.container_versions = container_versions
        self.volume_versions = volume_versions
        self.merges = merges
        self.intents = intents
        self.events = events
        self.replicasets = replicasets   # for cache invalidation only
        self.volumes = volumes
        self.idempotency = idempotency   # keyed-mutation result cache
        self.traces = traces             # crash-stitched replay spans

    # ------------------------------------------------------------- entry

    def run(self) -> dict:
        report = {
            "intentsReplayed": [],
            "opsCompleted": [],
            "orphanContainersRemoved": [],
            "containersRecreated": [],
            "containersStarted": [],
            "containersAdopted": [],
            "layersCopied": 0,
            "grantsFreed": {"tpu": 0, "cpu": 0, "ports": 0},
            "grantsRemarked": {"tpu": 0, "cpu": 0, "ports": 0},
            "versionFixes": 0,
            "orphanVolumesRemoved": [],
            "volumesMigrated": 0,
            "droppedReplayed": 0,
            "idempotency": {"finalized": 0, "dropped": 0, "expired": 0},
            "unknownIntentOps": [],
        }
        # make store reads current before cross-checking anything
        self.wq.join()
        # idemKey -> how the intent replay settled that mutation; the
        # idempotency sweep below settles the key's cache entry the SAME
        # way, so a post-crash client retry sees exactly one state change
        idem_outcomes: dict[str, str] = {}
        for rec in self.intents.open_intents():
            ops_before = len(report["opsCompleted"])
            replay_ok = True
            try:
                # crash stitching: the intent record carries the ORIGINAL
                # request's (traceId, spanId) — the replay's spans (backend
                # ops, store writes, layer copies) join that trace, so
                # GET /api/v1/traces/{traceId} after a crash shows ingress
                # -> mutation -> crash -> recovery as ONE causal tree
                with obs_trace.resume_trace(
                        self.traces, rec.meta.get("traceId", ""),
                        rec.meta.get("spanId", ""),
                        f"reconcile.{rec.op}", target=rec.target):
                    self._replay_intent(rec, report)
            except Exception:  # noqa: BLE001 — one bad intent must not
                log.exception("replaying intent %s:%s", rec.kind, rec.target)
                replay_ok = False
            self.intents.clear(rec.kind, rec.target)
            report["intentsReplayed"].append(
                f"{rec.kind}:{rec.target}:{rec.op}")
            key = rec.meta.get("idemKey", "")
            if key:
                # a failed replay must NOT finalize the key as done — drop
                # it instead, so the client's retry re-executes and the
                # services' own guards arbitrate. Same for a PARTIAL
                # intent (one of several journaled by a single request,
                # e.g. drain): completing one migration says nothing
                # about the request as a whole — re-execute.
                newly = report["opsCompleted"][ops_before:]
                completed = (replay_ok
                             and not rec.meta.get("idemPartial")
                             and not any("-unwound:" in s for s in newly))
                idem_outcomes[key] = "completed" if completed else "unwound"
        if self.idempotency is not None:
            report["idempotency"] = self.idempotency.reconcile_boot(
                idem_outcomes)
        self._reconcile_grants(report)
        self._reconcile_containers(report)
        self._reconcile_versions(report)
        self._reconcile_volumes(report)
        report["droppedReplayed"] = self.wq.replay_dropped()
        self.wq.join()
        report["actions"] = (
            len(report["intentsReplayed"])
            + len(report["opsCompleted"])
            + len(report["orphanContainersRemoved"])
            + len(report["containersRecreated"])
            + len(report["containersStarted"])
            + report["layersCopied"]
            + sum(report["grantsFreed"].values())
            + sum(report["grantsRemarked"].values())
            + report["versionFixes"]
            + len(report["orphanVolumesRemoved"])
            + report["volumesMigrated"]
            + report["droppedReplayed"]
            # TTL-expired records are routine hygiene, not evidence of a
            # dirty shutdown — only settled crash leftovers count
            + report["idempotency"]["finalized"]
            + report["idempotency"]["dropped"]
            # an op this reconciler cannot replay is version drift — loud,
            # not a silent skip (it still clears, but the operator must see)
            + len(report["unknownIntentOps"]))
        if self.events is not None:
            self.events.record("reconcile", code=200,
                               actions=report["actions"],
                               intents=len(report["intentsReplayed"]),
                               orphans=len(report["orphanContainersRemoved"]),
                               freed=dict(report["grantsFreed"]))
        if report["actions"]:
            log.warning("reconcile: %d corrective actions: %s",
                        report["actions"], report)
        return report

    # ----------------------------------------------------- store readers

    def _stored_containers(self) -> dict[str, StoredContainerInfo]:
        out = {}
        for kv in self.client.range(CONTAINERS):
            name = kv.key.rsplit("/", 1)[1]
            try:
                out[name] = StoredContainerInfo.deserialize(kv.value)
            except (ValueError, KeyError, TypeError):
                log.exception("unreadable container record %s", name)
        return out

    def _stored_volumes(self) -> dict[str, StoredVolumeInfo]:
        out = {}
        for kv in self.client.range(VOLUMES):
            name = kv.key.rsplit("/", 1)[1]
            try:
                out[name] = StoredVolumeInfo.deserialize(kv.value)
            except (ValueError, KeyError, TypeError):
                log.exception("unreadable volume record %s", name)
        return out

    def _stored(self, name: str) -> Optional[StoredContainerInfo]:
        kv = self.client.get(CONTAINERS, name)
        return StoredContainerInfo.deserialize(kv.value) if kv else None

    # ---------------------------------------------------- intent replay

    def _replay_intent(self, rec: IntentRecord, report: dict) -> None:
        handler = {
            "run": self._replay_run,
            "replace": self._replay_replace,
            "stop": self._replay_stop,
            "delete": self._replay_delete,
            "volume.create": self._replay_volume_create,
            "volume.scale": self._replay_volume_scale,
            "volume.delete": self._replay_volume_delete,
            "gateway.scale": self._replay_gateway_scale,
            "gateway.delete": self._replay_gateway_delete,
            "defrag": self._replay_defrag,
        }.get(rec.op)
        if handler is None:
            # an op nobody here can replay means a NEWER (or corrupt)
            # daemon journaled it: surface it on the event log and the
            # reconcile report instead of silently clearing — the mutation
            # it describes is in an unknown half-done state
            log.warning("unknown intent op %r for %s — clearing",
                        rec.op, rec.target)
            report["unknownIntentOps"].append(
                f"{rec.kind}:{rec.target}:{rec.op}")
            if self.events is not None:
                # key is intentOp: EventLog.record's first positional IS
                # `op` (the event name) — passing op= again would TypeError
                self.events.record("reconcile.unknown_op", target=rec.target,
                                   code=500, intentOp=rec.op, kind=rec.kind)
            return
        unknown_steps = [s for s in rec.step_names() if s not in KNOWN_STEPS]
        if unknown_steps:
            # same drift class, finer grain: the op replays, but markers
            # this build has never heard of contribute nothing to it
            log.warning("intent %s:%s carries unknown step(s) %s",
                        rec.kind, rec.target, unknown_steps)
            if self.events is not None:
                self.events.record("reconcile.unknown_step",
                                   target=rec.target, code=500,
                                   steps=unknown_steps, intentOp=rec.op)
        handler(rec, report)

    def _purge_container_state(self, name: str, report: dict) -> None:
        """Remove every trace of a replicaSet: backend containers, version
        counter, per-version keys, merge entries, grants owned by it."""
        for ctr in self.backend.list_names(name + "-"):
            if not ctr[len(name) + 1:].isdigit():
                continue   # prefix-sharing sibling (e.g. "web-api-1"), not ours
            try:
                self.backend.remove(ctr, force=True)
                report["orphanContainersRemoved"].append(ctr)
            except Exception:  # noqa: BLE001
                log.exception("removing %s", ctr)
        self._free_all_owned(name, report)
        if self.container_versions.get(name) is not None:
            self.container_versions.remove(name)
            report["versionFixes"] += 1
        dropped = self.client.delete_entity_versions(CONTAINERS, name)
        report["versionFixes"] += dropped
        self.merges.remove_replicaset(name)
        self.client.delete(CONTAINERS, name)
        if self.replicasets is not None:
            self.replicasets.invalidate(name)

    def _free_all_owned(self, owner: str, report: dict) -> None:
        """Free every scheduler grant held by `owner` (owner-checked).
        Reads go through the locked snapshot accessors: the runtime
        `?run=1` reconcile runs while the API serves, and iterating a
        scheduler's LIVE dict races concurrent grants (dict-changed-size
        mid-iteration). The restore below is owner-checked, so acting on
        a snapshot that a concurrent mutation has already outdated can
        never free someone else's grant."""
        chips = [i for i, o in self.tpu.owners().items() if o == owner]
        if chips:
            self.tpu.restore(chips, owner)
            report["grantsFreed"]["tpu"] += len(chips)
        shared = self.tpu.release_owner_shares(owner)
        report["grantsFreed"]["tpu"] += len(shared)
        cores = [i for i, o in self.cpu.owners().items() if o == owner]
        if cores:
            self.cpu.restore(cores, owner)
            report["grantsFreed"]["cpu"] += len(cores)
        ports = [p for p, o in self.ports.owners().items() if o == owner]
        if ports:
            self.ports.restore(ports, owner)
            report["grantsFreed"]["ports"] += len(ports)

    def _replay_defrag(self, rec: IntentRecord, report: dict) -> None:
        """A defrag run died mid-eviction. The umbrella intent carries no
        recovery of its own: every tenant move journaled its OWN replace
        intent (replayed above like any interrupted replace), and the next
        defrag run re-diagnoses live state — already-moved tenants no
        longer occupy the box, so the re-run is a smaller plan, not a
        repeat. Clearing the record (done by the caller) is the whole
        replay."""
        report["opsCompleted"].append(f"defrag-cleared:{rec.target}")

    def _replay_run(self, rec: IntentRecord, report: dict) -> None:
        """A run that never persisted its record is fully unwound; one that
        did is left for the cross-check passes to adopt."""
        if self._stored(rec.target) is None:
            self._purge_container_state(rec.target, report)
            report["opsCompleted"].append(f"run-unwound:{rec.target}")

    def _replay_replace(self, rec: IntentRecord, report: dict) -> None:
        """Patch / rollback / restart died mid-replace. The stored record
        names the surviving version; the one replace step the later passes
        can't redo is the writable-layer copy — do it here while the old
        container still exists, before the orphan sweep removes it."""
        stored = self._stored(rec.target)
        if stored is None:
            # even the original run's record is gone (write-behind loss):
            # nothing to roll forward to — unwind like an aborted run
            self._purge_container_state(rec.target, report)
            report["opsCompleted"].append(f"replace-unwound:{rec.target}")
            return
        old_ctr = rec.meta.get("oldContainer", "")
        new_ctr = stored.containerName
        if not rec.has_step("created"):
            # died before anything was created: the only side effects are
            # grants, which the grant cross-check pass frees — the replace
            # did NOT commit (an idempotent retry must re-execute, so this
            # must never read as "-completed")
            report["opsCompleted"].append(f"replace-unwound:{rec.target}")
            return
        new_version = rec.step_meta("created").get("version")
        if new_version is not None and stored.version != new_version:
            # latest pointer still names the OLD version: the new one was
            # never persisted — drop its container and history key, revert
            # the version counter; grants diff out in the grant pass
            failed = f"{rec.target}-{new_version}"
            if self.backend.inspect(failed).exists:
                try:
                    self.backend.remove(failed, force=True)
                    report["orphanContainersRemoved"].append(failed)
                except Exception:  # noqa: BLE001
                    log.exception("removing %s", failed)
            if self.client.delete_entity_version(CONTAINERS, rec.target,
                                                 new_version):
                report["versionFixes"] += 1
            report["opsCompleted"].append(f"replace-unwound:{rec.target}")
            return
        # rolled forward: stored already names the new version
        if old_ctr and old_ctr != new_ctr and not rec.has_step("copied"):
            old_state = self.backend.inspect(old_ctr)
            if old_state.exists and (old_state.running or old_state.paused):
                try:
                    self.backend.stop(old_ctr)
                except Exception:  # noqa: BLE001
                    log.exception("stopping %s for layer copy", old_ctr)
            if copy_container_layer(self.backend, old_ctr, new_ctr):
                report["layersCopied"] += 1
        report["opsCompleted"].append(f"replace-completed:{rec.target}")

    def _replay_stop(self, rec: IntentRecord, report: dict) -> None:
        """Complete a half-done stop: the user asked for it, so finish the
        backend stop, free the grants, and persist the release flag (the
        grant cross-check trusts that flag, so it must be settled first)."""
        stored = self._stored(rec.target)
        if stored is None:
            # no record to stop: nothing committed — must not read as a
            # completed stop for the idempotency-outcome inference
            report["opsCompleted"].append(f"stop-unwound:{rec.target}")
            return
        if stored.resourcesReleased:
            return      # already settled: the stop IS complete
        state = self.backend.inspect(stored.containerName)
        if state.exists and (state.running or state.paused):
            try:
                self.backend.stop(stored.containerName)
            except Exception:  # noqa: BLE001
                log.exception("completing stop of %s", stored.containerName)
        spec = stored.spec
        if spec.tpu_shares and spec.tpu_chips:
            self.tpu.restore_shares(spec.tpu_chips[0], spec.tpu_shares,
                                    rec.target)
        else:
            self.tpu.restore(spec.tpu_chips, rec.target)
        self.cpu.restore(spec.cpuset, rec.target)
        self.ports.restore(list(spec.port_bindings.values()), rec.target)
        stored.resourcesReleased = True
        self.client.put(CONTAINERS, rec.target, stored.serialize())
        if self.replicasets is not None:
            self.replicasets.invalidate(rec.target)
        report["opsCompleted"].append(f"stop-completed:{rec.target}")

    def _replay_delete(self, rec: IntentRecord, report: dict) -> None:
        self._purge_container_state(rec.target, report)
        report["opsCompleted"].append(f"delete-completed:{rec.target}")

    # -------------------------------------------- intent replay: volumes

    def _replay_volume_create(self, rec: IntentRecord, report: dict) -> None:
        if self.client.get(VOLUMES, rec.target) is not None:
            return     # record persisted: creation effectively completed
        vol = rec.step_meta("created").get("volume")
        if vol:
            try:
                self.backend.volume_remove(vol)
                report["orphanVolumesRemoved"].append(vol)
            except Exception:  # noqa: BLE001
                log.exception("removing %s", vol)
        if self.volume_versions.get(rec.target) is not None:
            self.volume_versions.remove(rec.target)
            report["versionFixes"] += 1
        report["versionFixes"] += self.client.delete_entity_versions(
            VOLUMES, rec.target)
        if self.volumes is not None:
            self.volumes.invalidate(rec.target)
        report["opsCompleted"].append(f"volume.create-unwound:{rec.target}")

    def _replay_volume_scale(self, rec: IntentRecord, report: dict) -> None:
        kv = self.client.get(VOLUMES, rec.target)
        if kv is None:
            # base record lost to write-behind: the scale cannot have
            # committed — never read as completed (see _replay_replace)
            report["opsCompleted"].append(
                f"volume.scale-unwound:{rec.target}")
            return
        stored = StoredVolumeInfo.deserialize(kv.value)
        old_vol = rec.meta.get("oldVolume", "")
        created = rec.step_meta("created")
        if not rec.has_step("created"):
            # died before the new version existed: nothing scaled — must
            # not read as completed (see _replay_replace)
            report["opsCompleted"].append(
                f"volume.scale-unwound:{rec.target}")
            return
        if created and stored.volumeName != created.get("volume"):
            # new version never persisted: drop its backend volume + key
            vol = created.get("volume", "")
            if vol and self.backend.volume_inspect(vol).exists:
                try:
                    self.backend.volume_remove(vol)
                    report["orphanVolumesRemoved"].append(vol)
                except Exception:  # noqa: BLE001
                    log.exception("removing %s", vol)
            v = created.get("version")
            if v is not None and self.client.delete_entity_version(
                    VOLUMES, rec.target, v):
                report["versionFixes"] += 1
            report["opsCompleted"].append(
                f"volume.scale-unwound:{rec.target}")
            return
        if (not rec.has_step("migrated") and old_vol
                and old_vol != stored.volumeName):
            # the != guard matters: a crash before the 'created' step leaves
            # stored pointing at the OLD volume — migrating it onto itself
            # would wreck the live data
            old_state = self.backend.volume_inspect(old_vol)
            new_state = self.backend.volume_inspect(stored.volumeName)
            if old_state.exists and new_state.exists:
                move_dir_contents(old_state.mountpoint, new_state.mountpoint)
                report["volumesMigrated"] += 1
        if self.volumes is not None:
            self.volumes.invalidate(rec.target)
        report["opsCompleted"].append(f"volume.scale-completed:{rec.target}")

    def _replay_volume_delete(self, rec: IntentRecord, report: dict) -> None:
        vol = rec.meta.get("volume", "")
        if vol and self.backend.volume_inspect(vol).exists:
            try:
                self.backend.volume_remove(vol)
            except Exception:  # noqa: BLE001
                log.exception("removing %s", vol)
        if not rec.meta.get("keepHistory"):
            if self.volume_versions.get(rec.target) is not None:
                self.volume_versions.remove(rec.target)
            self.client.delete(VOLUMES, rec.target)
            self.client.delete_entity_versions(VOLUMES, rec.target)
        if self.volumes is not None:
            self.volumes.invalidate(rec.target)
        report["opsCompleted"].append(f"volume.delete-completed:{rec.target}")

    # -------------------------------------------------- grant cross-check

    def _reconcile_grants(self, report: dict) -> None:
        stored = self._stored_containers()
        exp_tpu: dict[int, str] = {}
        exp_shares: dict[tuple[int, str], int] = {}
        exp_cpu: dict[int, str] = {}
        exp_ports: dict[int, str] = {}
        for name, info in stored.items():
            if info.resourcesReleased:
                continue
            if info.spec.tpu_shares and info.spec.tpu_chips:
                # fractional grant: expected in the SHARE ledger, never
                # the whole-chip bitmap (whole-marking a shared chip
                # would evict its co-tenants)
                exp_shares[(info.spec.tpu_chips[0], name)] = \
                    info.spec.tpu_shares
            else:
                for c in info.spec.tpu_chips:
                    exp_tpu[c] = name
            for c in self.cpu._cores(info.spec.cpuset):
                exp_cpu[c] = name
            for p in info.spec.port_bindings.values():
                exp_ports[int(p)] = name

        # share-ledger sweep: the stored records are authoritative — every
        # ledger holding is forced to exactly what a live record backs
        # (leaked quanta freed, lost quanta re-marked; owner+chip keyed,
        # so co-tenants on the same chip settle independently)
        want = dict(exp_shares)
        for chip, owners in self.tpu.shares_snapshot().items():
            for owner, q in owners.items():
                expect = want.pop((chip, owner), 0)
                if q != expect:
                    self.tpu.set_shares(chip, owner, expect)
                    key = "grantsFreed" if expect < q else "grantsRemarked"
                    report[key]["tpu"] += 1
        for (chip, owner), q in want.items():
            self.tpu.set_shares(chip, owner, q)
            report["grantsRemarked"]["tpu"] += 1

        def sweep(status: dict, expected: dict, restore, mark, key: str):
            # free grants whose owner the store doesn't back (leaked), or
            # that a different owner should hold; anonymous grants ("")
            # carry no owner to check against and are left alone
            for idx, owner in list(status.items()):
                if owner in (None, ""):
                    continue
                if expected.get(idx) != owner:
                    restore([idx], owner)
                    report["grantsFreed"][key] += 1
            # re-mark recorded grants the bitmap lost
            for idx, owner in expected.items():
                if status.get(idx) != owner:
                    mark([idx], owner)
                    report["grantsRemarked"][key] += 1

        # snapshots, not live maps (see _free_all_owned): the sweep's
        # restore/mark calls are owner-checked per index, so a stale
        # snapshot entry resolves safely — but iterating the live dict
        # while a request thread grants would not
        sweep(self.tpu.owners(), exp_tpu, self.tpu.restore,
              self.tpu.mark_used, "tpu")
        sweep(self.cpu.owners(), exp_cpu, self.cpu.restore,
              self.cpu.mark_used, "cpu")
        sweep(self.ports.owners(), exp_ports, self.ports.restore,
              self.ports.mark_used, "ports")

    # ---------------------------------------------- container cross-check

    def _reconcile_containers(self, report: dict) -> None:
        stored = self._stored_containers()
        current = {info.containerName for info in stored.values()}
        exclusive = getattr(self.backend, "exclusive_substrate", True)
        for ctr in self.backend.list_names():
            if ctr in current or not _MANAGED_NAME.fullmatch(ctr):
                continue
            if not exclusive and not self._knows_container(ctr.rpartition("-")[0],
                                                           stored):
                continue   # shared daemon: shape alone doesn't prove ours
            try:
                self.backend.remove(ctr, force=True)
                report["orphanContainersRemoved"].append(ctr)
            except Exception:  # noqa: BLE001
                log.exception("removing orphan container %s", ctr)
        for name, info in stored.items():
            state = self.backend.inspect(info.containerName)
            if not state.exists:
                # the substrate lost it (host reboot, manual docker rm):
                # rebuild from the stored spec — this is the adopt path's
                # hard case, and supervision re-arms because the substrate
                # tracks whatever it (re)creates
                try:
                    self.backend.create(info.containerName, info.spec)
                    if not info.resourcesReleased:
                        self.backend.start(info.containerName)
                    report["containersRecreated"].append(info.containerName)
                except Exception:  # noqa: BLE001
                    log.exception("recreating %s", info.containerName)
            elif (not state.running and not state.paused
                  and not info.resourcesReleased and state.exit_code is None):
                # created-but-never-started crash window; containers that
                # ran and exited on their own are left to restart policy
                try:
                    self.backend.start(info.containerName)
                    report["containersStarted"].append(info.containerName)
                except Exception:  # noqa: BLE001
                    log.exception("starting %s", info.containerName)
            else:
                report["containersAdopted"].append(info.containerName)

    def _knows_container(self, base: str, stored: dict) -> bool:
        """Any store acquaintance with a replicaSet base name — enough to
        claim a shared-substrate container as this control plane's."""
        return (base in stored
                or self.container_versions.get(base) is not None
                or bool(self.client.entity_versions(CONTAINERS, base)))

    # ------------------------------------------------ version consistency

    def _reconcile_versions(self, report: dict) -> None:
        stored = self._stored_containers()
        for name, info in stored.items():
            v = self.container_versions.get(name)
            if v is None or v < info.version:
                self.container_versions.set(name, info.version)
                report["versionFixes"] += 1
                v = info.version
            for ver, _ in self.client.entity_versions(CONTAINERS, name):
                if ver > v:
                    self.client.delete_entity_version(CONTAINERS, name, ver)
                    report["versionFixes"] += 1
        for name in self.container_versions.items():
            if name not in stored:
                self.container_versions.remove(name)
                report["versionFixes"] += 1
        for name, info in self._stored_volumes().items():
            v = self.volume_versions.get(name)
            if v is None or v < info.version:
                self.volume_versions.set(name, info.version)
                report["versionFixes"] += 1

    # ------------------------------------------- intent replay: gateways

    def _replay_gateway_scale(self, rec: IntentRecord, report: dict) -> None:
        """A gateway scale died mid-flight. The replica's own `run` /
        `stop` intent (journaled by the inner mutation) settles the
        replica's containers and grants; this record settles the
        REQUEST's outcome for the idempotency sweep: the scale completed
        exactly when the replica's stored record reflects the requested
        direction. The gateway's replica roster itself is derived from
        stored container records at boot (gateway.py adopt-by-name), so
        there is no roster state to repair here."""
        replica = rec.meta.get("replica", "")
        stored = self._stored(replica) if replica else None
        if rec.meta.get("direction") == "down":
            done = stored is None or stored.resourcesReleased
        else:
            # up completed only if the replica HOLDS capacity: a crashed
            # warm re-admission leaves its pre-existing record with
            # resourcesReleased=True, which must read as unwound (the
            # scale added nothing; a keyed retry re-executes)
            done = stored is not None and not stored.resourcesReleased
        outcome = "completed" if done else "unwound"
        report["opsCompleted"].append(
            f"gateway.scale-{outcome}:{rec.target}")

    def _replay_gateway_delete(self, rec: IntentRecord, report: dict) -> None:
        """Finish a half-done gateway delete: purge every replica
        replicaSet the roster scan still finds (idempotent — already-
        deleted replicas purge to nothing) and drop the gateway record."""
        from .gateway import GATEWAYS, replica_names_for
        for rname in replica_names_for(self.client, rec.target):
            self._purge_container_state(rname, report)
        if self.client.get(GATEWAYS, rec.target) is not None:
            self.client.delete(GATEWAYS, rec.target)
        report["opsCompleted"].append(
            f"gateway.delete-completed:{rec.target}")

    # -------------------------------------------------- volume cross-check

    def _reconcile_volumes(self, report: dict) -> None:
        if not getattr(self.backend, "exclusive_substrate", True):
            # shared daemon: a foreign volume's data is unrecoverable and
            # name shape proves nothing — leave orphan GC to the operator
            return
        stored = self._stored_volumes()
        known = set(stored) | set(self.volume_versions.items())
        for vol in self.backend.volume_list():
            if not _MANAGED_NAME.fullmatch(vol):
                continue   # not this control plane's naming: never remove
            base = vol.rpartition("-")[0]
            if base in known:
                continue
            if self.client.entity_versions(VOLUMES, base):
                continue   # history kept on purpose (?noall delete)
            try:
                self.backend.volume_remove(vol)
                report["orphanVolumesRemoved"].append(vol)
            except Exception:  # noqa: BLE001
                log.exception("removing orphan volume %s", vol)
