"""App: route table + handlers + full process wiring.

Reference parity: the route set of internal/routers/replicaset.go:22-57
(12 replicaSet endpoints), volume.go:20-26 (5 volume endpoints),
resource.go:12-16 (3 resource reads) and the /ping health route
(cmd/gpu-docker-api/main.go:119-123), with the same request validation and
error-code mapping, served under /api/v1. `/resources/tpus` replaces
`/resources/gpus` (the old path is kept as an alias).

App also plays the reference's program.Init role (main.go:53-97): it wires
store -> workqueue -> schedulers -> version maps -> backend -> services.

The port's copy of the JAX control plane's server/app.py, over the card
scheduler (GpuScheduler: `tpu` and the `/tpus` routes keep JAX's names).
Every plane of the JAX daemon is served: the inference gateways and their
SO_REUSEPORT data-plane workers (gateway.py, server/workers.py), the fleet
and its warm-standby replication (server/fleet.py, replication.py), and
placement and defrag (placement.py, defrag.py).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Optional

from .. import federation
from .. import idempotency as idem
from .. import xerrors
from ..backend import make_backend
from ..backend.base import Backend
from ..backend.docker import DockerBackend
from ..backend.guard import GuardedBackend, breaker_gauge
from ..dtos import ContainerRun, PatchRequest
from ..events import EventLog
from ..health import HealthMonitor
from ..idempotency import IdempotencyCache
from ..intents import IntentJournal
from ..meshplan import PlanSpec
from ..obs import metrics as obs_metrics
from ..obs.metrics import Registry
from ..obs.recorder import FlightRecorder
from ..obs.trace import TraceCollector
from ..gateway import GatewayConfig, GatewayManager
from ..defrag import Defragmenter
from ..placement import DEFAULT_POLICY, POLICIES, FleetModel
from ..reconcile import Reconciler
from .. import regulator
from ..schedulers import (
    SHARE_QUANTA, CpuScheduler, GpuScheduler, PortScheduler, parse_gpu_count,
)
from ..services import ReplicaSetService, VolumeService
from .. import replication
from ..replication import StandbyReplicator
from ..store import StateClient, StoreReadOnlyError, open_store
from ..topology import GpuTopology, discover_topology
from ..utils import copyfast
from ..utils.file import valid_size_unit
from ..version import (
    CONTAINER_VERSION_MAP_KEY, VOLUME_VERSION_MAP_KEY, MergeMap, VersionMap,
)
from ..workqueue import WorkQueue
from .codes import ResCode
from .fleet import FleetPlane
from .http import (
    ApiServer, RawResponse, Request, Response, Router, StreamingResponse,
    err, ok, precondition_failed, too_many, unavailable,
)

log = logging.getLogger(__name__)


def _if_match(req: Request):
    """Parse the optional If-Match version precondition header. Accepts a
    bare or quoted integer; anything else is a client error."""
    raw = req.headers.get("If-Match", "").strip().strip('"')
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"If-Match must be an integer version, got {raw!r}")


class MutationGate:
    """Bounded-concurrency admission control for mutating requests.

    Overload on the keep-alive stack used to be absorbed by letting
    every request in: threads pile up behind the name locks and the WAL,
    latency grows unboundedly, and the eventual failures strike mid-
    mutation. This gate sheds EARLY instead — before any grant, version
    bump, or journal write exists:

    - at most `max_inflight` mutations execute concurrently (semaphore);
    - at most `max_waiting` more may queue for a slot (watermark); the
      queue wait is bounded by `wait_timeout`;
    - per-client fairness: one remote address may hold at most
      `per_client` slots (executing + queued), so a single runaway
      client saturating the gate cannot starve the rest.

    A shed answers HTTP 429 + Retry-After. Counters feed /metrics
    (tdapi_mutations_*)."""

    def __init__(self, max_inflight: int = 32, max_waiting: int = 64,
                 per_client: Optional[int] = None,
                 wait_timeout: float = 10.0):
        self.max_inflight = max(1, max_inflight)
        self.max_waiting = max(0, max_waiting)
        self.per_client = (per_client if per_client and per_client > 0
                           else self.max_inflight)
        self.wait_timeout = wait_timeout
        self._cond = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        # FIFO ticket queue: newcomers may not barge past parked waiters
        # (a sustained arrival stream would otherwise starve the queue
        # into spurious queue_timeout sheds)
        self._fifo: deque = deque()
        self._per_client: dict[str, int] = {}
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_by_reason = {"per_client": 0, "queue_full": 0,
                               "queue_timeout": 0}

    def _drop_client(self, client: str) -> None:
        n = self._per_client.get(client, 0) - 1
        if n <= 0:
            self._per_client.pop(client, None)
        else:
            self._per_client[client] = n

    def _shed(self, reason: str) -> str:
        self.shed_total += 1
        self.shed_by_reason[reason] += 1
        return reason

    def acquire(self, client: str) -> Optional[str]:
        """Admit (returns None; caller MUST release()) or shed (returns
        the reason)."""
        with self._cond:
            if self._per_client.get(client, 0) >= self.per_client:
                return self._shed("per_client")
            self._per_client[client] = self._per_client.get(client, 0) + 1
            if self._inflight < self.max_inflight and not self._fifo:
                self._inflight += 1
                self.admitted_total += 1
                return None
            if self._waiting >= self.max_waiting:
                self._drop_client(client)
                return self._shed("queue_full")
            ticket = object()
            self._fifo.append(ticket)
            self._waiting += 1
            deadline = time.monotonic() + self.wait_timeout
            try:
                while (self._inflight >= self.max_inflight
                       or self._fifo[0] is not ticket):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._drop_client(client)
                        return self._shed("queue_timeout")
                    self._cond.wait(left)
                self._inflight += 1
                self.admitted_total += 1
                return None
            finally:
                self._waiting -= 1
                try:
                    self._fifo.remove(ticket)
                except ValueError:
                    pass
                # whether admitted or timed out, the head may have moved:
                # wake everyone so the new head rechecks (bounded by
                # max_waiting, so notify_all stays cheap)
                self._cond.notify_all()

    def release(self, client: str) -> None:
        with self._cond:
            self._inflight -= 1
            self._drop_client(client)
            self._cond.notify_all()

    def describe(self) -> dict:
        with self._cond:
            return {
                "inflight": self._inflight,
                "waiting": self._waiting,
                "maxInflight": self.max_inflight,
                "maxWaiting": self.max_waiting,
                "perClient": self.per_client,
                "admittedTotal": self.admitted_total,
                "shedTotal": self.shed_total,
                "shedByReason": dict(self.shed_by_reason),
            }


class _WrappingRouter:
    """Registration facade used by App._router(): every mutating method
    (POST/PATCH/DELETE) is wrapped with the admission gate + idempotency
    middleware at add() time, so no mutating route can forget it.
    raw=True opts a route out — ONLY for data-plane traffic (the gateway
    generate route): serving requests are not control mutations, must not
    consume mutation-gate slots, and apply their own admission policy
    (gateway.py queue bound + deadline)."""

    MUTATING = ("POST", "PATCH", "DELETE")

    def __init__(self, router: Router, app: "App"):
        self._router = router
        self._app = app

    def add(self, method: str, pattern: str, handler,
            raw: bool = False) -> None:
        if not raw and method.upper() in self.MUTATING:
            handler = self._app._mutating(handler)
        self._router.add(method, pattern, handler)


class App:
    def __init__(self, state_dir: str = "./tpu-docker-api-state",
                 backend: str = "mock",
                 addr: str = "127.0.0.1:2378",
                 port_range: Optional[tuple[int, int]] = None,
                 topology: Optional[GpuTopology] = None,
                 api_key: Optional[str] = None,
                 cpu_cores: Optional[int] = None,
                 store_engine: str = "auto",
                 store_maint_records: int = 5000,
                 volume_tiers: Optional[dict] = None,
                 warm_pool: int = 0,
                 supervise: bool = False,
                 guard_backend: bool = False,
                 health_interval: float = 0.0,
                 auto_cordon: bool = True,
                 max_inflight_mutations: Optional[int] = None,
                 mutation_queue_depth: Optional[int] = None,
                 per_client_mutations: Optional[int] = None,
                 mutation_wait_timeout: float = 10.0,
                 idem_ttl: Optional[float] = None,
                 gw_workers: Optional[int] = None,
                 gw_data_port: Optional[int] = None,
                 fleet_member: Optional[str] = None,
                 fleet_host: Optional[str] = None,
                 fleet_ttl: Optional[float] = None,
                 repl_peer: Optional[str] = None,
                 placement_policy: Optional[str] = None,
                 defrag_interval: Optional[float] = None):
        os.makedirs(state_dir, exist_ok=True)
        self.state_dir = state_dir

        def _env_int(name: str, given: Optional[int], default: int) -> int:
            if given is not None:
                return given
            try:
                return int(os.environ.get(name, "") or default)
            except ValueError:
                return default

        # admission control for mutating routes: shed with 429 before any
        # grant is taken instead of queueing unboundedly (MutationGate)
        self.gate = MutationGate(
            max_inflight=_env_int("TDAPI_MAX_INFLIGHT_MUTATIONS",
                                  max_inflight_mutations, 32),
            max_waiting=_env_int("TDAPI_MUTATION_QUEUE_DEPTH",
                                 mutation_queue_depth, 64),
            per_client=_env_int("TDAPI_PER_CLIENT_MUTATIONS",
                                per_client_mutations, 0) or None,
            wait_timeout=mutation_wait_timeout)
        if idem_ttl is None:
            try:
                idem_ttl = float(os.environ.get("TDAPI_IDEM_TTL", "") or
                                 idem.DEFAULT_TTL)
            except ValueError:
                idem_ttl = idem.DEFAULT_TTL
        self._idem_ttl = idem_ttl
        # WAL maintenance trigger: when the record count crosses this,
        # compact + rewrite (0 disables). The reference leans on an external
        # etcd's auto-compaction — which its revision walker then breaks
        # under; here compaction preserves the history prefixes by design.
        self.store_maint_records = store_maint_records
        self._maint_stop = None
        # --- reference Init order: docker -> etcd -> workQueue -> schedulers
        #     -> version maps (main.go:53-97) ---
        self.events = EventLog(state_dir)
        # span sink: mutations traced end-to-end land here (bounded ring,
        # keep-slowest retention, traces.jsonl) — GET /api/v1/traces
        self.traces = TraceCollector(state_dir)
        # every store mutation feeds the watch hub in exact revision
        # order (federation.WatchedStore) — the seam GET /api/v1/watch
        # and the fleet's list+watch informers resume against
        self.hub = federation.WatchHub()
        self.store = federation.WatchedStore(
            open_store(wal_path=os.path.join(state_dir, "state.wal"),
                       engine=store_engine),
            self.hub)
        self.client = StateClient(self.store)
        self.wq = WorkQueue(self.client, events=self.events)
        self.wq.start()
        # a Backend INSTANCE is accepted so a control-plane restart can be
        # driven against a still-alive substrate (crash-recovery tests; an
        # embedding daemon supervising its own backend)
        if isinstance(backend, Backend):
            self.backend = backend
            if not getattr(backend, "volume_tiers", None):
                backend.volume_tiers = dict(volume_tiers or {})
        else:
            self.backend = make_backend(backend,
                                        os.path.join(state_dir, "backend"),
                                        volume_tiers=volume_tiers,
                                        warm_pool=warm_pool,
                                        supervise=supervise)
        # substrate fault tolerance: deadlines + retries + circuit breaker
        # (backend/guard.py). The daemon (cli.py) turns this on; embedded
        # test Apps opt in explicitly so unit substrates stay transparent.
        if guard_backend and not isinstance(self.backend, GuardedBackend):
            self.backend = GuardedBackend(self.backend, events=self.events)
        # a pre-guarded backend instance (tests; embedding daemons) gets its
        # breaker transitions onto THIS App's event log
        if (isinstance(self.backend, GuardedBackend)
                and self.backend.breaker.events is None):
            self.backend.breaker.events = self.events
        # the inner (unguarded) backend: health probes must keep seeing the
        # substrate while the breaker refuses workload ops, and the event
        # log rides on it so quota-tool stalls surface on /api/v1/events
        inner = getattr(self.backend, "inner", self.backend)
        if getattr(inner, "events", None) is None and hasattr(inner, "events"):
            inner.events = self.events
        # an explicit topology overrides the store; otherwise boot from stored
        # state (crash-resume) and only probe the host on first run
        if topology is None and self.client.get("tpus", "tpuStatusMap") is None:
            topology = discover_topology()
        self.tpu = GpuScheduler(self.client, self.wq, topology=topology)
        # the docker substrate names its CDI devices by the node's card
        # UUIDs, which only the topology knows
        if isinstance(inner, DockerBackend) and inner.topology is None:
            inner.topology = self.tpu.topology
        self.cpu = CpuScheduler(self.client, self.wq, core_count=cpu_cores)
        self.ports = PortScheduler(self.client, self.wq, port_range=port_range)
        # health monitor probes the UNGUARDED substrate (see above); it
        # feeds the scheduler's cordon set, which drain acts on
        self.health = HealthMonitor(inner, self.tpu, events=self.events,
                                    interval=health_interval,
                                    auto_cordon=auto_cordon)
        self.container_versions = VersionMap(CONTAINER_VERSION_MAP_KEY,
                                             self.client, self.wq)
        self.volume_versions = VersionMap(VOLUME_VERSION_MAP_KEY,
                                          self.client, self.wq)
        self.merges = MergeMap(self.client, self.wq)
        self.intents = IntentJournal(self.client)
        # exactly-once mutation replay: keyed requests persist their
        # result here; duplicates get the stored response (idempotency.py)
        self.idempotency = IdempotencyCache(self.client, ttl=self._idem_ttl)
        self.intents.idempotency = self.idempotency
        self.replicasets = ReplicaSetService(
            self.backend, self.client, self.wq, self.tpu, self.cpu, self.ports,
            self.container_versions, self.merges,
            intents=self.intents, events=self.events)
        self.volumes = VolumeService(self.backend, self.client, self.wq,
                                     self.volume_versions,
                                     intents=self.intents)
        # crash recovery: replay open intents, cross-check grants/backends,
        # BEFORE the API starts serving (a request racing the repair could
        # observe — or grab — a resource mid-reconcile)
        self.reconciler = Reconciler(
            self.backend, self.client, self.wq, self.tpu, self.cpu,
            self.ports, self.container_versions, self.volume_versions,
            self.merges, self.intents, events=self.events,
            replicasets=self.replicasets, volumes=self.volumes,
            idempotency=self.idempotency, traces=self.traces)
        self._reconcile_lock = threading.Lock()
        self.last_reconcile = self.reconciler.run()
        # per-chip concurrency regulators (fractional co-tenancy): route
        # their preempt events onto this App's event log and export their
        # counters at /metrics
        regulator.set_events(self.events)
        # inference gateways (gateway.py): rebuilt from their stored
        # records AFTER the reconciler settled half-done scale mutations —
        # replica rosters are re-derived from stored container records
        self.gateways = GatewayManager(self.replicasets, self.client,
                                       self.intents, events=self.events,
                                       traces=self.traces)
        self.gateways.boot()
        # multi-process SO_REUSEPORT data plane (server/workers.py): N
        # worker processes share the gateway data-plane port, each
        # parsing/routing/admitting end-to-end against the shared-memory
        # router state; 0/unset (or no native shm-atomics core) keeps the
        # in-process single-daemon data plane
        from . import workers as gw_workers_mod
        self.workers = None
        # per-process flight recorder (obs/recorder.py): every event row
        # mirrors into a cheap bounded ring, flushed to the state dir on
        # graceful stop (the cli's SIGTERM handler drives App.stop) — the
        # daemon's own postmortem segment, the in-process twin of the
        # workers' shm rings
        self.recorder = FlightRecorder()
        self.events.mirror = self.recorder.note_event
        n_workers = _env_int(gw_workers_mod.GW_WORKERS_ENV, gw_workers, 0)
        if n_workers > 0:
            if gw_workers_mod.available():
                self.workers = gw_workers_mod.WorkerTier(
                    self.gateways, n=n_workers,
                    port=_env_int(gw_workers_mod.GW_DATA_PORT_ENV,
                                  gw_data_port, 0),
                    events=self.events,
                    traces=self.traces,
                    spool_dir=os.path.join(state_dir, "spans"),
                    api_key=(api_key if api_key is not None
                             else os.environ.get("APIKEY", "")))
                # worker-served requests merge into the SAME latency
                # family the in-process path observes into: the family is
                # truthful whichever tier served the request (metric-
                # family parity). Cleared in stop() — the instrument is
                # module-global and this App's tier must not outlive it.
                obs_metrics.GATEWAY_LATENCY.set_extern(
                    self.workers.latency_extern)
            else:
                log.warning("TDAPI_GW_WORKERS=%d but the worker tier is "
                            "unavailable (native shm-atomics core not "
                            "built?) — serving stays in-process",
                            n_workers)
        # fleet control plane (server/fleet.py): the arbiter is ALWAYS
        # hosted (any daemon can be the --fleet-host others point at);
        # a member seat only when configured — a single-daemon
        # deployment pays neither heartbeats nor ownership checks. The
        # member is configured in start(): its advertised address is
        # this server's BOUND port, which does not exist yet.
        if fleet_ttl is None:
            try:
                fleet_ttl = float(os.environ.get("TDAPI_FLEET_TTL", "")
                                  or federation.DEFAULT_TTL)
            except ValueError:
                fleet_ttl = federation.DEFAULT_TTL
        self.fleet = FleetPlane(self.store, self.hub, events=self.events,
                                ttl=fleet_ttl)
        self._fleet_member_id = (fleet_member
                                 or os.environ.get("TDAPI_FLEET_MEMBER", ""))
        self._fleet_host = (fleet_host if fleet_host is not None
                            else os.environ.get("TDAPI_FLEET_HOST", ""))
        self._api_key = (api_key if api_key is not None
                         else os.environ.get("APIKEY", ""))
        # warm-standby replication (replication.py): tail a peer daemon's
        # watch stream into a local replica store; on a fleet takeover
        # the promote hook installs the dead peer's records from it.
        # Constructed here (the replica opens immediately — promote must
        # work even before start()), the tail thread starts in start().
        self._repl_peer = (repl_peer
                           or os.environ.get("TDAPI_REPL_PEER", ""))
        self.replicator: Optional[StandbyReplicator] = None
        if self._repl_peer:
            self.replicator = StandbyReplicator(
                self._repl_peer, os.path.join(state_dir, "replica"),
                api_key=self._api_key, engine=store_engine,
                events=self.events)
        # heterogeneity-aware placement (placement.py) + defragmenter
        # (defrag.py). The fleet model is ALWAYS built — GET /placement
        # and the tdapi_placement_* gauges read it — but the scored
        # enumerate→score→claim path only engages when a policy is
        # configured (param or TDAPI_PLACEMENT_POLICY); unset keeps the
        # mechanism layer's first-fit byte-for-byte, so single-daemon
        # deployments pay nothing new.
        policy = (placement_policy
                  or os.environ.get("TDAPI_PLACEMENT_POLICY", "") or "")
        if policy and policy not in POLICIES:
            raise ValueError(f"unknown placement policy {policy!r}; "
                             f"known: {sorted(POLICIES)}")
        self.placement_policy = policy
        self.placer = FleetModel(
            {self.tpu.topology.generation: self.tpu},
            policy=policy or DEFAULT_POLICY, events=self.events)
        if policy:
            self.replicasets.placer = self.placer

        def _owns(name: str) -> bool:
            # federation gate: on a fleet member, defrag may only migrate
            # replicaSets THIS daemon owns — moving a peer's tenant would
            # race its owner's mutations
            m = self.fleet.member
            return m is None or ("containers", name) in m.owned

        self.defrag = Defragmenter(self.placer, self.replicasets,
                                   events=self.events, owns=_owns)
        if defrag_interval is None:
            try:
                defrag_interval = float(
                    os.environ.get("TDAPI_DEFRAG_INTERVAL", "0") or 0)
            except ValueError:
                defrag_interval = 0.0
        self._defrag_interval = defrag_interval
        # store.read_only event edge detector (one event per latch trip)
        self._ro_trips_seen = 0
        # SSE follower count (tdapi_events_stream_clients) — mutated from
        # stream generator threads under this lock
        self._stream_lock = threading.Lock()
        self._stream_clients = 0
        self.metrics = self._build_registry()
        self.server = ApiServer(
            self._router(), addr=addr, api_key=api_key,
            events=self.events, traces=self.traces,
            # the serving data plane must not write one event row per
            # request: at load it evicts the whole control-plane ring
            # (scale/shed events included) and taxes every decode
            quiet_routes=frozenset(
                {("POST", "/api/v1/gateways/:name/generate")}))

    # ------------------------------------------------------------- routes

    def _router(self) -> Router:
        base = Router()
        r = _WrappingRouter(base, self)
        v1 = "/api/v1"
        r.add("GET", "/ping", lambda req: ok({"status": "pong"}))
        r.add("POST", f"{v1}/replicaSet", self.h_run)
        r.add("POST", f"{v1}/replicaSet/:name/commit", self.h_commit)
        r.add("POST", f"{v1}/replicaSet/:name/execute", self.h_execute)
        r.add("PATCH", f"{v1}/replicaSet/:name", self.h_patch)
        r.add("PATCH", f"{v1}/replicaSet/:name/rollback", self.h_rollback)
        r.add("PATCH", f"{v1}/replicaSet/:name/stop", self.h_stop)
        r.add("PATCH", f"{v1}/replicaSet/:name/restart", self.h_restart)
        r.add("PATCH", f"{v1}/replicaSet/:name/pause", self.h_pause)
        r.add("PATCH", f"{v1}/replicaSet/:name/continue", self.h_continue)
        r.add("GET", f"{v1}/replicaSet/:name", self.h_info)
        r.add("GET", f"{v1}/replicaSet/:name/history", self.h_history)
        r.add("DELETE", f"{v1}/replicaSet/:name", self.h_delete)
        r.add("POST", f"{v1}/volumes", self.h_vol_create)
        r.add("PATCH", f"{v1}/volumes/:name/size", self.h_vol_patch)
        r.add("DELETE", f"{v1}/volumes/:name", self.h_vol_delete)
        r.add("GET", f"{v1}/volumes/:name", self.h_vol_info)
        r.add("GET", f"{v1}/volumes/:name/history", self.h_vol_history)
        r.add("POST", f"{v1}/gateways", self.h_gw_create)
        r.add("GET", f"{v1}/gateways", self.h_gw_list)
        r.add("GET", f"{v1}/gateways/:name", self.h_gw_info)
        r.add("PATCH", f"{v1}/gateways/:name/scale", self.h_gw_scale)
        r.add("DELETE", f"{v1}/gateways/:name", self.h_gw_delete)
        # DATA PLANE: serving traffic, not a control mutation — bypasses
        # the mutation gate + idempotency middleware (raw); the gateway
        # applies its own admission policy (queue bound, deadline, shed)
        r.add("POST", f"{v1}/gateways/:name/generate", self.h_gw_generate,
              raw=True)
        r.add("GET", f"{v1}/events", self.h_events)
        # list+watch on MVCC revisions + fleet lease/grant plane
        # (server/fleet.py; the fleet routes register raw — heartbeat
        # traffic must not consume mutation-gate slots)
        r.add("GET", f"{v1}/watch", self.h_watch)
        self.fleet.register(r, v1)
        r.add("GET", f"{v1}/traces", self.h_traces)
        r.add("GET", f"{v1}/traces/:traceId", self.h_trace)
        r.add("GET", f"{v1}/reconcile", self.h_reconcile)
        r.add("GET", f"{v1}/healthz", self.h_healthz)
        r.add("POST", f"{v1}/tpus/:id/cordon", self.h_cordon)
        r.add("POST", f"{v1}/tpus/:id/uncordon", self.h_uncordon)
        r.add("POST", f"{v1}/tpus/drain", self.h_drain)
        r.add("GET", f"{v1}/placement", self.h_placement)
        r.add("POST", f"{v1}/placement/defrag", self.h_defrag)
        r.add("GET", "/metrics", self.h_metrics)
        r.add("GET", "/openapi.json", self.h_openapi)
        r.add("GET", f"{v1}/resources/tpus", self.h_res_tpus)
        r.add("GET", f"{v1}/resources/gpus", self.h_res_tpus)  # legacy alias
        r.add("GET", f"{v1}/resources/cpus", self.h_res_cpus)
        r.add("GET", f"{v1}/resources/ports", self.h_res_ports)
        return base

    # -------------------------------------- mutation middleware (tentpole)

    def _mutating(self, handler):
        """Wrap a mutating handler: admission gate first (shed with 429
        BEFORE any grant/journal write exists), then Idempotency-Key
        replay, then the handler."""
        def wrapped(req: Request) -> Response:
            # If-Match parsed ONCE here for every mutating route (the
            # handlers read req.if_match); malformed is a client error
            # and must not consume a gate slot
            try:
                req.if_match = _if_match(req)
            except ValueError as e:
                return err(ResCode.InvalidParams, str(e))
            reason = self.gate.acquire(req.client_addr or "?")
            if reason is not None:
                self.events.record("admission.shed", target=req.path,
                                   code=int(ResCode.TooManyRequests),
                                   reason=reason, request_id=req.request_id)
                return too_many(reason)
            try:
                # fleet ownership: a member daemon refuses mutations for
                # resources the hash ring assigns elsewhere (the refusal
                # names the owner so the client re-routes) — BEFORE the
                # idempotency layer, so a refused call caches nothing
                denied = self.fleet.guard_mutation(req)
                if denied is not None:
                    return denied
                denials = getattr(self.store, "read_only_denials", 0)
                resp = self._with_idempotency(req, handler)
                if getattr(self.store, "read_only_denials", 0) > denials:
                    # the latch refused a write inside this request but
                    # a handler-level catch-all swallowed the typed
                    # refusal — the store's denial counter is the truth
                    return self._read_only_response(
                        req, getattr(self.store, "read_only", None)
                        or "WAL write failed",
                        getattr(self.store, "read_only_retry_s", 0.0))
                return resp
            except StoreReadOnlyError as e:
                return self._read_only_response(req, e.reason,
                                                e.retry_after)
            finally:
                self.gate.release(req.client_addr or "?")
        return wrapped

    def _read_only_response(self, req: Request, reason: str,
                            retry_after: float) -> Response:
        """WAL append failed (ENOSPC &c): the store latched read-only.
        Degrade, don't crash — 503 + Retry-After matched to the store's
        re-probe window, one event per latch trip (docs/durability.md)."""
        trips = getattr(self.store, "read_only_trips", 0)
        if trips > self._ro_trips_seen:
            self._ro_trips_seen = trips
            self.events.record(
                "store.read_only", target=req.path,
                code=int(ResCode.BackendUnavailable),
                reason=reason, request_id=req.request_id)
        return Response(
            ResCode.BackendUnavailable,
            {"reason": f"store is read-only: {reason}"},
            http_status=503,
            headers={"Retry-After": str(max(1, int(retry_after)))})

    def _with_idempotency(self, req: Request, handler) -> Response:
        key = req.headers.get("Idempotency-Key", "").strip()
        if not key:
            return handler(req)
        fp = idem.fingerprint(req.method, req.path, req.body, req.query)
        state, rec = self.idempotency.begin(key, fp)
        if state == idem.MISMATCH:
            return err(ResCode.InvalidParams,
                       "Idempotency-Key reused with a different request")
        if state == idem.IN_FLIGHT:
            # a live request holds this key right now: the duplicate must
            # neither execute nor pretend an outcome — 409, retry shortly
            return Response(ResCode.Conflict, None, http_status=409,
                            headers={"Retry-After": "1"})
        if state == idem.REPLAY:
            self.events.record("idempotency.replay", target=req.path,
                               code=rec.get("code", 200),
                               request_id=req.request_id)
            resp = RawResponse(rec.get("payload", "").encode(),
                               "application/json")
            resp.http_status = rec.get("httpStatus", 200)
            resp.headers = dict(rec.get("headers", {}))
            resp.headers["Idempotency-Replayed"] = "true"
            try:
                resp.code = ResCode(rec.get("code", 200))
            except ValueError:
                pass    # event log shows 200; the payload carries the code
            return resp
        # state == NEW: execute with the key active so intents.begin()
        # journals it (crash recovery settles cache + state together)
        try:
            with idem.context(key):
                resp = handler(req)
        except Exception:
            # clean unwind: the mutation did not happen — drop the claim
            # so a retry re-executes (an InjectedCrash/BaseException skips
            # this, exactly like a daemon death would)
            self.idempotency.abandon(key)
            raise
        if int(resp.code) != 200:
            # errors never changed state (the services unwind before
            # returning), so a retry is always safe to re-execute — and
            # caching one would pin a transient failure (breaker open,
            # substrate timeout mapped to a *Failed envelope) past its
            # recovery. Only success is replay-worthy.
            self.idempotency.abandon(key)
            return resp
        self.idempotency.finish(key, int(resp.code), resp.http_status,
                                resp.payload(), resp.headers)
        return resp

    # ------------------------------------------------- replicaSet handlers

    def _validate_mesh_plan(self, plan_json, tpu_count) -> Optional[Response]:
        """Admission validation for a request's meshPlan: well-formed axis
        factors, product == tpuCount (strict at the wire — an explicit
        plan that doesn't multiply out is a client mistake even when
        trivial), and geometrically hostable on this slice's topology.
        Returns the 1000 error Response, or None when valid/absent."""
        if plan_json is None:
            return None
        try:
            plan = PlanSpec.from_json(plan_json)
            plan.validate_count(tpu_count)
        except ValueError as e:
            return err(ResCode.InvalidParams, str(e))
        if not self.tpu.plan_feasible(plan):
            return err(
                ResCode.InvalidParams,
                f"meshPlan {plan.to_json()} cannot map onto the "
                f"{self.tpu.topology.accelerator_type} topology "
                f"(shape {list(self.tpu.topology.shape)}): no sub-box "
                f"hosts these axis factors ICI-contiguously")
        return None

    def h_run(self, req: Request) -> Response:
        spec = ContainerRun.from_json(req.json())
        if not spec.imageName:
            return err(ResCode.ImageNameCannotBeEmpty)
        if not spec.replicaSetName:
            return err(ResCode.ContainerNameCannotBeEmpty)
        if "-" in spec.replicaSetName:
            return err(ResCode.ContainerNameCannotContainDash)
        if spec.tpuCount < 0:
            return err(ResCode.TpuCountMustBeGreaterThanOrEqualZero)
        try:
            parse_gpu_count(spec.tpuCount)
        except ValueError as e:
            return err(ResCode.InvalidParams, str(e))
        if spec.priority not in regulator.PRIORITIES:
            return err(ResCode.InvalidParams,
                       f"priority must be one of {regulator.PRIORITIES[1:]}")
        bad = self._validate_mesh_plan(spec.meshPlan, spec.tpuCount)
        if bad is not None:
            return bad
        if spec.cpuCount < 0:
            return err(ResCode.CpuCountMustBeGreaterThanOrEqualZero)
        if spec.memory and not valid_size_unit(spec.memory):
            return err(ResCode.ContainerMemorySizeNotSupported)
        try:
            return ok(self.replicasets.run_container(spec))
        except xerrors.ContainerExistedError:
            return err(ResCode.ContainerAlreadyExist)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            # a capacity-refused gang may be fragmentation-blocked, which
            # waiting never fixes — note it for the background defragmenter
            if spec.meshPlan:
                self.defrag.note_infeasible(int(spec.tpuCount),
                                            spec.meshPlan)
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.CpuNotEnoughError:
            return err(ResCode.ContainerCpuNotEnough)
        except xerrors.PortNotEnoughError:
            return err(ResCode.ContainerPortNotEnough)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("run failed [%s]", req.request_id)
            return err(ResCode.ContainerRunFailed)

    def h_patch(self, req: Request) -> Response:
        name = req.params["name"]
        body = req.json()
        patch = PatchRequest.from_json(body)
        tp = patch.tpuPatch
        if tp is not None:
            if tp.tpuCount < 0:
                return err(ResCode.TpuCountMustBeGreaterThanOrEqualZero)
            try:
                parse_gpu_count(tp.tpuCount)
            except ValueError as e:
                return err(ResCode.InvalidParams, str(e))
            bad = self._validate_mesh_plan(tp.meshPlan, tp.tpuCount)
            if bad is not None:
                return bad
        cp = patch.cpuPatch
        if cp is not None and cp.cpuCount < 0:
            return err(ResCode.CpuCountMustBeGreaterThanOrEqualZero)
        mp = patch.memoryPatch
        if mp is not None and not valid_size_unit(mp.memory):
            return err(ResCode.ContainerMemorySizeNotSupported)
        try:
            return ok(self.replicasets.patch_container(
                name, patch, if_match=req.if_match))
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.NoPatchRequiredError:
            return err(ResCode.ContainerNoNeedPatch)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.CpuNotEnoughError:
            return err(ResCode.ContainerCpuNotEnough)
        except xerrors.PortNotEnoughError:
            return err(ResCode.ContainerPortNotEnough)
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("patch failed [%s]", req.request_id)
            return err(ResCode.ContainerPatchFailed)

    def h_rollback(self, req: Request) -> Response:
        name = req.params["name"]
        version = int(req.json().get("version", -1))
        if version < 0:
            return err(ResCode.ContainerVersionMustBeGreaterThanOrEqualZero)
        try:
            return ok(self.replicasets.rollback_container(
                name, version, if_match=req.if_match))
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.NoRollbackRequiredError:
            return err(ResCode.ContainerNoNeedRollback)
        except (xerrors.NotExistInStoreError, xerrors.VersionNotFoundError):
            return err(ResCode.ContainerRollbackFailed)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("rollback failed [%s]", req.request_id)
            return err(ResCode.ContainerRollbackFailed)

    def h_stop(self, req: Request) -> Response:
        try:
            self.replicasets.stop_container(req.params["name"],
                                            if_match=req.if_match)
            return ok()
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("stop failed [%s]", req.request_id)
            return err(ResCode.ContainerStopFailed)

    def h_restart(self, req: Request) -> Response:
        try:
            return ok(self.replicasets.restart_container(
                req.params["name"], if_match=req.if_match))
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("restart failed [%s]", req.request_id)
            return err(ResCode.ContainerRestartFailed)

    def h_pause(self, req: Request) -> Response:
        try:
            self.replicasets.pause_container(req.params["name"])
            return ok()
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("pause failed [%s]", req.request_id)
            return err(ResCode.ContainerShutDownFailed)

    def h_continue(self, req: Request) -> Response:
        try:
            self.replicasets.startup_container(req.params["name"])
            return ok()
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("continue failed [%s]", req.request_id)
            return err(ResCode.ContainerStartUpFailed)

    def h_execute(self, req: Request) -> Response:
        body = req.json()
        cmd = body.get("cmd") or []
        workdir = body.get("workDir", "")
        try:
            out = self.replicasets.execute_container(req.params["name"], cmd, workdir)
            return ok({"output": out})
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("execute failed [%s]", req.request_id)
            return err(ResCode.ContainerExecuteFailed)

    def h_commit(self, req: Request) -> Response:
        new_image = req.json().get("newImageName", "")
        if not new_image:
            return err(ResCode.InvalidParams)
        try:
            image_id = self.replicasets.commit_container(req.params["name"], new_image)
            return ok({"imageId": image_id, "imageName": new_image})
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("commit failed [%s]", req.request_id)
            return err(ResCode.ContainerCommitFailed)

    def h_info(self, req: Request) -> Response:
        try:
            return ok({"info": self.replicasets.get_container_info(req.params["name"])})
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetInfoFailed)

    def h_history(self, req: Request) -> Response:
        try:
            return ok({"history": self.replicasets.get_container_history(req.params["name"])})
        except xerrors.NotExistInStoreError:
            return err(ResCode.ContainerGetHistoryFailed)

    def h_delete(self, req: Request) -> Response:
        try:
            self.replicasets.delete_container(req.params["name"],
                                              if_match=req.if_match)
            return ok()
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("delete failed [%s]", req.request_id)
            return err(ResCode.ContainerDeleteFailed)

    # ----------------------------------------------------- volume handlers

    def h_vol_create(self, req: Request) -> Response:
        body = req.json()
        name = body.get("name", "")
        size = body.get("size", "")
        if "-" in name:
            return err(ResCode.VolumeNameNotContainsDash)
        if name.startswith("/"):
            return err(ResCode.VolumeNameNotBeginWithForwardSlash)
        if not name:
            return err(ResCode.VolumeNameCannotBeEmpty)
        if size and not valid_size_unit(size):
            return err(ResCode.VolumeSizeNotSupported)
        try:
            return ok(self.volumes.create_volume(
                name, size, tier=body.get("tier", "")))
        except xerrors.VolumeExistedError:
            return err(ResCode.VolumeExisted)
        except ValueError as e:
            # client input error (e.g. unknown tier) — return the
            # actionable message, don't bury it in a server stack trace
            return err(ResCode.VolumeCreateFailed, str(e))
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("volume create failed [%s]", req.request_id)
            return err(ResCode.VolumeCreateFailed)

    def h_vol_patch(self, req: Request) -> Response:
        name = req.params["name"]
        size = req.json().get("size", "")
        if not valid_size_unit(size):
            return err(ResCode.VolumeSizeNotSupported)
        try:
            return ok(self.volumes.patch_volume_size(name, size,
                                                     if_match=req.if_match))
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.NoPatchRequiredError:
            return err(ResCode.VolumeSizeNoNeedPatch)
        except xerrors.VolumeSizeUsedGreaterThanReducedError:
            return err(ResCode.VolumeSizeUsedGreaterThanReduce)
        except xerrors.NotExistInStoreError:
            return err(ResCode.VolumeGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("volume patch failed [%s]", req.request_id)
            return err(ResCode.VolumePatchFailed)

    def h_vol_delete(self, req: Request) -> Response:
        # ?noall keeps history (reference routers/volume.go:121-127)
        try:
            self.volumes.delete_volume(req.params["name"],
                                       keep_history=req.query_flag("noall"),
                                       if_match=req.if_match)
            return ok()
        except xerrors.PreconditionFailedError as e:
            return precondition_failed(e)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("volume delete failed [%s]", req.request_id)
            return err(ResCode.VolumeDeleteFailed)

    def h_vol_info(self, req: Request) -> Response:
        try:
            return ok({"info": self.volumes.get_volume_info(req.params["name"])})
        except xerrors.NotExistInStoreError:
            return err(ResCode.VolumeGetInfoFailed)

    def h_vol_history(self, req: Request) -> Response:
        try:
            return ok({"history": self.volumes.get_volume_history(req.params["name"])})
        except xerrors.NotExistInStoreError:
            return err(ResCode.VolumeGetHistoryFailed)

    # ---------------------------------------------------- gateway handlers

    def h_gw_create(self, req: Request) -> Response:
        try:
            cfg = GatewayConfig.from_json(req.json())
            cfg.validate()
        except (ValueError, TypeError) as e:
            return err(ResCode.InvalidParams, str(e))
        try:
            return ok({"gateway": self.gateways.create(cfg)})
        except xerrors.GatewayExistedError:
            return err(ResCode.GatewayExisted)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.CpuNotEnoughError:
            return err(ResCode.ContainerCpuNotEnough)
        except xerrors.PortNotEnoughError:
            return err(ResCode.ContainerPortNotEnough)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("gateway create failed [%s]", req.request_id)
            return err(ResCode.GatewayCreateFailed)

    def h_gw_list(self, req: Request) -> Response:
        return ok({"gateways": self.gateways.list()})

    def h_gw_info(self, req: Request) -> Response:
        try:
            return ok({"gateway": self.gateways.get(
                req.params["name"]).describe()})
        except xerrors.NotExistInStoreError:
            return err(ResCode.GatewayGetInfoFailed)

    def h_gw_scale(self, req: Request) -> Response:
        try:
            n = int(req.json().get("replicas", -1))
        except (TypeError, ValueError):
            return err(ResCode.InvalidParams)
        if n < 0:
            return err(ResCode.InvalidParams,
                       "replicas must be an integer >= 0")
        try:
            return ok({"gateway": self.gateways.scale_to(
                req.params["name"], n)})
        except xerrors.NotExistInStoreError:
            return err(ResCode.GatewayGetInfoFailed)
        except xerrors.GpuOversubscribedError:
            return err(ResCode.ContainerTpuOversubscribed)
        except xerrors.GpuNotEnoughError:
            return err(ResCode.ContainerTpuNotEnough)
        except xerrors.CpuNotEnoughError:
            return err(ResCode.ContainerCpuNotEnough)
        except xerrors.PortNotEnoughError:
            return err(ResCode.ContainerPortNotEnough)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("gateway scale failed [%s]", req.request_id)
            return err(ResCode.GatewayScaleFailed)

    def h_gw_delete(self, req: Request) -> Response:
        try:
            self.gateways.delete(req.params["name"])
            return ok()
        except xerrors.NotExistInStoreError:
            return err(ResCode.GatewayGetInfoFailed)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("gateway delete failed [%s]", req.request_id)
            return err(ResCode.GatewayDeleteFailed)

    def h_gw_generate(self, req: Request) -> Response:
        """The serving data plane: route one generate request through the
        gateway's continuous-batching router. The replica's envelope is
        relayed verbatim (RawResponse); ?stream=1 relays it as a
        close-delimited streamed body (StreamingResponse) instead of
        buffering."""
        try:
            gw = self.gateways.get(req.params["name"])
        except xerrors.NotExistInStoreError:
            return err(ResCode.GatewayGetInfoFailed)
        # strict-priority admission class (the gateway twin of the
        # regulator's latency class): an SLO-bound caller stamps it and
        # bypasses the best-effort burst queue
        priority = req.header("X-TDAPI-Priority").strip().lower()
        try:
            if req.query_flag("stream"):
                _status, chunks = gw.forward(req.body, stream=True,
                                             priority=priority)
                return StreamingResponse(chunks,
                                         content_type="application/json")
            _status, payload = gw.forward(req.body, priority=priority)
            return RawResponse(payload)
        except xerrors.GatewayShedError:
            self.events.record("gateway.shed", target=req.params["name"],
                               code=int(ResCode.TooManyRequests),
                               reason="queue_full",
                               request_id=req.request_id)
            return too_many("gateway queue full")
        except xerrors.GatewayDeadlineError as e:
            self.events.record("gateway.shed", target=req.params["name"],
                               code=int(ResCode.GatewayTimeout),
                               reason="deadline",
                               request_id=req.request_id)
            return Response(ResCode.GatewayTimeout, None, msg=str(e),
                            http_status=504,
                            headers={"Retry-After": "1"})
        except xerrors.GatewayRetryBudgetError as e:
            # retry-budget exhaustion sheds instead of amplifying a
            # brownout: 503 with a Retry-After the client can honor
            self.events.record("gateway.shed", target=req.params["name"],
                               code=int(ResCode.BackendUnavailable),
                               reason="retry_budget",
                               request_id=req.request_id)
            return Response(ResCode.BackendUnavailable, None, msg=str(e),
                            http_status=503,
                            headers={"Retry-After": str(e.retry_after)})
        except Exception:  # noqa: BLE001
            log.exception("gateway generate failed [%s]", req.request_id)
            return err(ResCode.GatewayRequestFailed)

    # --------------------------------------------------- resource handlers

    def h_events(self, req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", ["200"])[0])
        except ValueError:
            return err(ResCode.InvalidParams)
        if limit < 0:
            return err(ResCode.InvalidParams)
        target = req.query.get("target", [""])[0]
        if req.query_flag("follow"):
            return self._follow_events(req, target)
        return ok({"events": self.events.recent(limit=limit, target=target)})

    #: SSE heartbeat cadence (seconds) — a comment frame per idle interval
    #: keeps middleboxes from reaping the socket and tells the client the
    #: stream is alive; ?heartbeat= overrides per request (tests), floor
    #: 50ms so a typo can't busy-spin a connection thread
    SSE_HEARTBEAT_S = 15.0

    def _follow_events(self, req: Request, target: str) -> Response:
        """`GET /api/v1/events?follow=1` — Server-Sent Events.

        Subscribe instead of polling (the seed of ROADMAP item 3's watch
        API): each event goes out as `id: <seq>` + `data: <json>`; a
        reconnecting client sends `Last-Event-ID` (header, or the
        lastEventId query param) and resumes from the ring — a resume
        point the ring has already evicted past gets an explicit
        `event: gap` frame naming the first retained seq (the client
        raises EventGapError / refetches instead of silently missing
        events), then the retained tail. Heartbeat comments mark idle
        intervals."""
        try:
            hb = float(req.query.get(
                "heartbeat", [str(self.SSE_HEARTBEAT_S)])[0])
        except ValueError:
            return err(ResCode.InvalidParams)
        if not math.isfinite(hb):
            # inf/nan parse as floats but overflow Condition.wait's C
            # timestamp — reject, don't crash the stream thread
            return err(ResCode.InvalidParams)
        hb = min(max(0.05, hb), 3600.0)
        last_id = req.header("Last-Event-ID") or \
            req.query.get("lastEventId", [""])[0]
        try:
            # no resume point -> only NEW events (subscribe-from-now)
            since = int(last_id) if str(last_id).strip() else \
                self.events.last_seq
        except ValueError:
            return err(ResCode.InvalidParams)

        # ring-overrun detection BEFORE streaming: the client resumed
        # from a seq whose successor has already been evicted — events
        # are gone, and a silent seq jump is indistinguishable from a
        # quiet target filter. first_retained == 0 (empty ring) only
        # happens when nothing was ever recorded OR capacity is 0;
        # either way nothing after `since` was lost unless seq moved on.
        first = self.events.first_retained
        gap = None
        if str(last_id).strip() and since < (first - 1 if first
                                             else self.events.last_seq):
            gap = {"firstRetained": first, "lastEventId": since}
            self.events.record("watch.gap", target="events",
                               detail=gap, request_id=req.request_id)

        def gen(since: int):
            with self._stream_lock:
                self._stream_clients += 1
            try:
                yield b"retry: 2000\n\n"
                if gap is not None:
                    yield (f"event: gap\ndata: "
                           f"{json.dumps(gap)}\n\n").encode()
                last_sent = time.monotonic()
                while not self.server._draining:
                    evts = self.events.wait_since(since, timeout=hb)
                    out = []
                    for e in evts:
                        since = e["seq"]
                        # never echo this stream's OWN request event back
                        # to its follower (it lands in the ring after the
                        # subscribe point was captured)
                        if e.get("requestId") == req.request_id:
                            continue
                        if target and e.get("target") != target:
                            continue
                        out.append(f"id: {e['seq']}\ndata: "
                                   f"{json.dumps(e)}\n\n".encode())
                    if out:
                        yield b"".join(out)
                        last_sent = time.monotonic()
                    elif time.monotonic() - last_sent >= hb:
                        # heartbeat on WRITE idleness, not event idleness:
                        # a busy daemon whose events all filter out must
                        # still keep the socket visibly alive
                        yield b": heartbeat\n\n"
                        last_sent = time.monotonic()
            finally:
                with self._stream_lock:
                    self._stream_clients -= 1

        return StreamingResponse(gen(since))

    def h_watch(self, req: Request) -> Response:
        """List+watch on MVCC revisions — see FleetPlane.h_watch for the
        wire contract (snapshot with ?list=1, else SSE of revision
        frames; `revision too old` forces a relist)."""
        return self.fleet.h_watch(req, lambda: self.server._draining)

    def _fleet_promote(self, resource: str, name: str) -> None:
        """Takeover promotion: before adopting `resource/name` stolen
        from a dead member, install the replica's copy of its record
        into this daemon's own store — so _fleet_adopt reconciles real
        state instead of a hole. Runs behind the steal's fencing epoch
        (FleetMember.heartbeat_once). Idempotent and non-destructive:
        a record this store already has wins (it is at least as fresh —
        this daemon may have served the resource before), so a crash
        between promote and adopt (crashpoint fed.after_promote) just
        re-runs it."""
        if self.replicator is None:
            return
        kv = self.replicator.get_record(resource, name)
        if kv is None:
            return    # the replica never saw it (or saw its deletion)
        key = replication.resource_key(resource, name)
        if self.store.get(key) is None:
            self.store.put(key, kv.value)

    def _fleet_adopt(self, resource: str, name: str) -> None:
        """Takeover adoption: this daemon just stole `resource/name`
        from a dead member. Derive-don't-store — nothing is copied from
        the dead owner; one reconciler pass cross-checks stored records
        against grants/backends/intents exactly like boot does, and an
        adopted gateway rebuilds its roster from stored container
        records (boot_one)."""
        with self._reconcile_lock:
            if not self.intents.open_intents():
                self.last_reconcile = self.reconciler.run()
        if resource == "gateways":
            self.gateways.boot_one(name)

    def h_traces(self, req: Request) -> Response:
        """Finished-trace summaries, slowest first; ?op= substring-matches
        the root op, ?minDurationMs= floors the duration."""
        op = req.query.get("op", [""])[0]
        try:
            min_ms = float(req.query.get("minDurationMs", ["0"])[0])
            limit = int(req.query.get("limit", ["100"])[0])
        except ValueError:
            return err(ResCode.InvalidParams)
        return ok({"traces": self.traces.list(op=op, min_duration_ms=min_ms,
                                              limit=limit),
                   "stats": self.traces.stats()})

    def h_trace(self, req: Request) -> Response:
        """One full trace: flat span list + assembled span tree."""
        t = self.traces.get(req.params["traceId"])
        if t is None:
            return err(ResCode.InvalidParams,
                       f"unknown traceId {req.params['traceId']!r} "
                       f"(evicted, or never seen)")
        return ok({"trace": t})

    def h_reconcile(self, req: Request) -> Response:
        """Admin view of crash recovery: the boot-time reconcile report;
        ?run=1 performs a fresh pass. The reconciler assumes nothing is in
        flight — an open intent at runtime IS an in-flight mutation (this
        daemon is alive), so refuse rather than replay it out from under
        the request thread that owns it."""
        if req.query_flag("run"):
            with self._reconcile_lock:
                if self.intents.open_intents():
                    return err(ResCode.ServerBusy,
                               "mutations in flight — retry when idle")
                self.last_reconcile = self.reconciler.run()
        return ok({"reconcile": self.last_reconcile})

    # ------------------------------------------- health / cordon / drain

    def h_healthz(self, req: Request) -> Response:
        """Component health report. When the background prober is off (or
        ?probe is given), a probe cycle runs inline so the answer is
        fresh, not a stale snapshot."""
        if req.query_flag("probe") or not self.health.report()["running"]:
            rep = self.health.probe_once()
        else:
            rep = self.health.report()
        breaker = None
        if isinstance(self.backend, GuardedBackend):
            breaker = self.backend.breaker.describe()
            if breaker["state"] != "closed":
                rep["status"] = "degraded"
        read_only = getattr(self.store, "read_only", None)
        if read_only:
            rep["status"] = "degraded"
        return ok({
            "status": rep["status"],
            "health": rep,
            "breaker": breaker,
            "workqueue": {"pending": self.wq.pending(),
                          "dropped": self.wq.dropped_count()},
            "workers": (self.workers.describe()
                        if self.workers is not None else None),
            # per-gateway tail-tolerance posture: knobs, probation roster,
            # ejection/hedge/retry-budget counters (gateway.py describe)
            "gateways": {g["name"]: {"tailTolerance": g["tailTolerance"]}
                         for g in self.gateways.list()},
            "reconcileActions": self.last_reconcile["actions"],
            "storeReadOnly": read_only,
            "replication": (self.replicator.describe()
                            if self.replicator is not None else None),
        })

    def _chip_index(self, req: Request) -> int:
        idx = int(req.params["id"])
        if idx not in self.tpu.owners():
            raise ValueError(f"unknown chip index {idx}")
        return idx

    def h_cordon(self, req: Request) -> Response:
        try:
            idx = self._chip_index(req)
        except ValueError as e:
            return err(ResCode.InvalidParams, str(e))
        cordoned = self.tpu.cordon([idx])
        self.events.record("tpu.cordon", target=str(idx), code=200,
                           request_id=req.request_id)
        return ok({"cordoned": cordoned})

    def h_uncordon(self, req: Request) -> Response:
        try:
            idx = self._chip_index(req)
        except ValueError as e:
            return err(ResCode.InvalidParams, str(e))
        cordoned = self.tpu.uncordon([idx])
        self.events.record("tpu.uncordon", target=str(idx), code=200,
                           request_id=req.request_id)
        return ok({"cordoned": cordoned})

    def h_drain(self, req: Request) -> Response:
        try:
            return ok({"drain": self.replicasets.drain_cordoned()})
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("drain failed [%s]", req.request_id)
            return err(ResCode.ServerBusy)

    def h_placement(self, req: Request) -> Response:
        """GET /placement: active policy, per-pool capacity/fragmentation
        views, profile ledgers, and the defragmenter's counters."""
        out = self.placer.describe()
        out["policyActive"] = bool(self.placement_policy)
        return ok({"placement": out, "defrag": self.defrag.describe()})

    def h_defrag(self, req: Request) -> Response:
        """POST /placement/defrag {tpuCount, meshPlan?}: synchronously run
        one defrag cycle for a fragmentation-blocked gang shape — the
        operator-driven twin of the background loop."""
        try:
            body = req.json() or {}
            n = int(body.get("tpuCount", body.get("n", 0)) or 0)
            if n <= 0:
                return err(ResCode.InvalidParams,
                           "tpuCount must be a positive whole-chip count")
            plan = (PlanSpec.from_json(body["meshPlan"])
                    if body.get("meshPlan") else None)
            if plan is not None and not plan.is_trivial \
                    and plan.size != n:
                return err(ResCode.InvalidParams,
                           f"meshPlan sized {plan.size} cannot shape a "
                           f"{n}-chip gang")
        except (ValueError, TypeError, KeyError) as e:
            return err(ResCode.InvalidParams, str(e))
        try:
            report = self.defrag.run_for(n, plan,
                                         requester=req.request_id)
        except xerrors.BackendUnavailableError as e:
            return unavailable(e)
        except Exception:  # noqa: BLE001
            log.exception("defrag failed [%s]", req.request_id)
            return err(ResCode.ServerBusy)
        return ok({"defrag": report})

    def _build_registry(self) -> Registry:
        """App-local metrics registry: every inventory/queue/gate series
        whose truth lives on THIS App's components, refreshed by one
        collect callback at scrape time. Module-global instruments (the
        latency histograms fed by guard/store/schedulers/regulator) live
        in obs_metrics.REGISTRY and render after these. Series names are
        the JAX daemon's, registered in obs/names.py."""
        m = Registry()
        g_chips = m.gauge("tdapi_tpu_chips", labels=("state",))
        g_cores = m.gauge("tdapi_cpu_cores", labels=("state",))
        g_ports = m.gauge("tdapi_ports", labels=("state",))
        g_rs = m.gauge("tdapi_replicasets")
        g_vols = m.gauge("tdapi_volumes")
        g_wq_pend = m.gauge("tdapi_workqueue_pending")
        g_wq_drop = m.gauge("tdapi_workqueue_dropped")
        g_wq_coal = m.gauge(
            "tdapi_workqueue_coalesced",
            "puts superseded by a newer same-key put before hitting the "
            "store", typ="counter")
        g_rec = m.gauge("tdapi_reconcile_actions")
        g_wal_rec = m.gauge("tdapi_store_wal_records")
        g_wal_fl = m.gauge(
            "tdapi_store_wal_flushes",
            "flushed_records / flushes = avg group-commit batch size",
            typ="counter")
        g_wal_flr = m.gauge("tdapi_store_wal_flushed_records", typ="counter")
        g_wal_max = m.gauge("tdapi_store_wal_flush_batch_max")
        g_health = m.gauge("tdapi_chip_health_failures")
        g_kills = m.gauge(
            "tdapi_backend_stop_kills",
            "stop() escalations: workload ignored SIGTERM for the whole "
            "stop timeout and ate a SIGKILL", typ="counter")
        g_reshards = m.gauge(
            "tdapi_reshards_total",
            "gang mesh-shape changes committed through the rolling "
            "replace (PATCH tpuCount/meshPlan on a MeshPlan'd set)",
            typ="counter")
        # rolling-replace data movement (utils/copyfast.py)
        g_cp_bytes = m.gauge("tdapi_replace_copy_bytes", typ="counter")
        g_cp_secs = m.gauge("tdapi_replace_copy_seconds", typ="counter")
        g_cp_mode = m.gauge(
            "tdapi_replace_copy_mode",
            "layer copies per resolved copy-ladder rung",
            labels=("mode",), typ="counter")
        g_downtime = m.gauge(
            "tdapi_replace_downtime_ms",
            "last replace's stop->start window (the chips-idle time)")
        g_delta = m.gauge(
            "tdapi_copy_delta_files",
            "files re-copied by delta passes (the dirty sets)",
            typ="counter")
        # fractional multi-tenancy: share ledger + serving-path regulators
        g_sh = m.gauge(
            "tdapi_tpu_shares_allocated",
            f"fractional-grant quanta held, per share-split chip "
            f"({SHARE_QUANTA} quanta = 1 chip)", labels=("chip",))
        g_sh_tot = m.gauge("tdapi_tpu_shares_allocated_total")
        g_sh_free = m.gauge(
            "tdapi_tpu_shares_allocatable",
            "quanta still grantable to fractional requests (excludes "
            "cordoned and whole-granted chips)")
        g_sh_util = m.gauge("tdapi_tpu_shares_utilization")
        g_reg_q = m.gauge("tdapi_regulator_queue_depth",
                          "tenants parked waiting for their next decode "
                          "chunk", labels=("chip",))
        g_reg_pre = m.gauge("tdapi_regulator_preemptions_total",
                            "best-effort chunks flagged to yield to a "
                            "latency tenant", labels=("chip",),
                            typ="counter")
        g_reg_ch = m.gauge("tdapi_regulator_chunks_total", labels=("chip",),
                           typ="counter")
        g_reg_t = m.gauge("tdapi_regulator_tenants", labels=("chip",))
        # admission gate + idempotency cache
        g_mut_in = m.gauge("tdapi_mutations_inflight")
        g_mut_wait = m.gauge("tdapi_mutations_waiting")
        g_mut_adm = m.gauge("tdapi_mutations_admitted_total", typ="counter")
        g_mut_shed = m.gauge(
            "tdapi_mutations_shed_total",
            "requests answered 429 before taking any grant", typ="counter")
        g_idem = m.gauge("tdapi_idempotency_records")
        g_idem_rep = m.gauge(
            "tdapi_idempotency_replays_total",
            "duplicate keyed mutations answered from the result cache",
            typ="counter")
        guarded = isinstance(self.backend, GuardedBackend)
        if guarded:
            g_brk = m.gauge("tdapi_breaker_state",
                            "0 = closed, 1 = half-open, 2 = open")
            g_brk_f = m.gauge("tdapi_breaker_consecutive_failures")
        # federation: fleet membership + grant table + watch hub
        # (declared unconditionally — family parity across single- and
        # multi-daemon deployments, zero-valued when no fleet)
        g_fed_mem = m.gauge("tdapi_fed_members",
                            "live-leased fleet members (this arbiter)")
        g_fed_gr = m.gauge("tdapi_fed_grants",
                           "resource grants in the fleet grant table")
        g_fed_own = m.gauge("tdapi_fed_owned",
                            "resources this daemon's member seat "
                            "believes it owns")
        g_fed_renew = m.gauge("tdapi_fed_renewals_total", typ="counter")
        g_fed_steal = m.gauge(
            "tdapi_fed_steals_total",
            "grants stolen from expired members (takeovers arbitrated)",
            typ="counter")
        g_fed_exp = m.gauge("tdapi_fed_expiries_total",
                            "leases lazily reaped after TTL",
                            typ="counter")
        g_fed_wev = m.gauge("tdapi_fed_watch_events_total",
                            "store mutations fed to the watch hub",
                            typ="counter")
        g_fed_whead = m.gauge("tdapi_fed_watch_head_revision",
                              "highest MVCC revision the watch hub has "
                              "seen")
        # warm-standby replication (replication.py). Declared
        # unconditionally — same family-parity contract as the fed
        # gauges; zero-valued when no --repl-peer is configured
        g_repl_hor = m.gauge("tdapi_repl_horizon",
                             "highest peer revision contiguously applied "
                             "to the replica store")
        g_repl_lag = m.gauge("tdapi_repl_lag_revisions",
                             "peer head minus replicated horizon")
        g_repl_ev = m.gauge("tdapi_repl_events_applied_total",
                            "watch events applied to the replica",
                            typ="counter")
        g_repl_rs = m.gauge("tdapi_repl_resyncs_total",
                            "full snapshot resyncs after WatchCompacted",
                            typ="counter")
        g_repl_con = m.gauge("tdapi_repl_connected",
                             "1 while the replication tail holds a live "
                             "watch stream to the peer")
        # tracing + streaming self-observation
        g_traces = m.gauge("tdapi_traces_retained",
                           "finished traces held in the ring "
                           "(keep-slowest retention, obs/trace.py)")
        g_followers = m.gauge("tdapi_events_stream_clients",
                              "live SSE followers of /api/v1/events")
        # inference gateways (gateway.py)
        g_gw_rep = m.gauge("tdapi_gateway_replicas",
                           "replica count per gateway and state",
                           labels=("gateway", "state"))
        g_gw_q = m.gauge("tdapi_gateway_queue_depth",
                         "requests parked in the gateway admission queue",
                         labels=("gateway",))
        g_gw_in = m.gauge("tdapi_gateway_inflight", labels=("gateway",))
        g_gw_req = m.gauge("tdapi_gateway_requests_total",
                           labels=("gateway",), typ="counter")
        g_gw_shed = m.gauge(
            "tdapi_gateway_shed_total",
            "gateway requests refused (queue bound or deadline)",
            labels=("gateway",), typ="counter")
        g_gw_scale = m.gauge("tdapi_gateway_scale_events_total",
                             labels=("gateway", "direction"),
                             typ="counter")
        # KV-aware routing: affinity picks by the in-process
        # router + every worker process (same family-parity contract as
        # the request counters), replica prefix-cache occupancy, and
        # disaggregated prefill->decode handoffs completed
        g_gw_aff = m.gauge("tdapi_gw_affinity_hits_total",
                           "requests steered to a prefix-warm replica "
                           "by the KV affinity scorer",
                           labels=("gateway",), typ="counter")
        g_gw_aff_tok = m.gauge(
            "tdapi_gw_affinity_tokens_total",
            "prompt tokens the affinity scorer predicted KV-resident on "
            "the picked replica", labels=("gateway",), typ="counter")
        g_kv_blocks = m.gauge("tdapi_kv_prefix_blocks",
                              "cached prefix entries advertised per "
                              "replica (X-TDAPI-KV-Occ)",
                              labels=("gateway", "replica"))
        g_kv_handoff = m.gauge(
            "tdapi_kv_prefix_handoffs_total",
            "disaggregated prefill->decode KV handoffs completed",
            labels=("gateway",), typ="counter")
        # tail-tolerant serving: gray-failure ejections by the
        # in-process router's control loop; hedges/wins and retry-budget
        # sheds are per-tier counters folded at scrape (same parity
        # contract as the request counters above)
        g_gw_eject = m.gauge(
            "tdapi_gateway_ejections_total",
            "replicas ejected into probation by the latency outlier "
            "detector", labels=("gateway",), typ="counter")
        g_gw_hedge = m.gauge(
            "tdapi_gateway_hedges_total",
            "hedged (duplicated) requests dispatched against a slow "
            "primary", labels=("gateway",), typ="counter")
        g_gw_hedge_win = m.gauge(
            "tdapi_gateway_hedge_wins_total",
            "hedged requests whose duplicate finished first",
            labels=("gateway",), typ="counter")
        g_gw_rb = m.gauge(
            "tdapi_gateway_retry_budget_exhausted_total",
            "requests shed 503 because the retry token bucket was empty",
            labels=("gateway",), typ="counter")
        # multi-process data-plane worker tier (server/workers.py +
        # obs/shm_metrics.py). Declared UNCONDITIONALLY: family presence
        # must not depend on TDAPI_GW_WORKERS, or dashboards built in one
        # mode break in the other (the metric-family parity contract —
        # same names/labels whichever tier serves; the values are simply
        # zero/empty when the tier is off)
        g_wk_alive = m.gauge("tdapi_gw_workers_alive",
                             "live SO_REUSEPORT data-plane workers")
        g_wk_respawn = m.gauge(
            "tdapi_gw_worker_respawns_total",
            "dead workers reaped and respawned by the watchdog",
            typ="counter")
        g_wk_req = m.gauge("tdapi_gw_worker_requests_total",
                           "data-plane requests served, per worker "
                           "process and gateway",
                           labels=("worker", "gateway"), typ="counter")
        g_wk_shed = m.gauge("tdapi_gw_worker_shed_total",
                            "queue-bound 429 sheds, per worker process",
                            labels=("worker", "gateway"), typ="counter")
        g_wk_dead = m.gauge("tdapi_gw_worker_deadline_total",
                            "deadline 504 kills, per worker process",
                            labels=("worker", "gateway"), typ="counter")
        g_wk_retry = m.gauge(
            "tdapi_gw_worker_retries_total",
            "replica transport failures retried on another replica, per "
            "worker process", labels=("worker", "gateway"), typ="counter")
        h_wk_qw = m.histogram(
            "tdapi_gw_worker_queue_wait_ms",
            "admission queue wait in the worker tier (claim start -> "
            "slot claimed), summed across workers per gateway",
            labels=("gateway",),
            buckets=obs_metrics.LATENCY_BUCKETS_MS)
        if self.workers is not None:
            h_wk_qw.set_extern(self.workers.queue_wait_extern)

        # heterogeneity-aware placement + defragmenter: the
        # families are declared unconditionally (family parity — a
        # single-pool no-policy daemon exports zeros, not absences)
        g_pl_pol = m.gauge("tdapi_placement_policy",
                           "active placement objective (value 1, policy "
                           "label; 0 when scoring is not engaged)",
                           labels=("policy",))
        g_pl_pools = m.gauge("tdapi_placement_pools")
        g_pl_free = m.gauge("tdapi_placement_free_chips",
                            "allocatable whole chips, per pool",
                            labels=("pool",))
        g_pl_box = m.gauge("tdapi_placement_largest_free_box",
                           "largest fully-free ICI-contiguous box, per "
                           "pool — the gang admission ceiling",
                           labels=("pool",))
        g_pl_frag = m.gauge("tdapi_placement_fragmentation",
                            "1 - largestFreeBox/freeChips, per pool",
                            labels=("pool",))
        g_pl_scored = m.gauge("tdapi_placement_scored_total",
                              "candidate boxes scored", typ="counter")
        g_pl_placed = m.gauge("tdapi_placement_placements_total",
                              "scored placements committed", typ="counter")
        g_df_runs = m.gauge("tdapi_defrag_runs_total", typ="counter")
        g_df_migs = m.gauge("tdapi_defrag_migrations_total",
                            "tenants migrated to open gang boxes",
                            typ="counter")
        g_df_moved = m.gauge("tdapi_defrag_moved_chips_total", typ="counter")
        g_df_lost = m.gauge("tdapi_defrag_steps_lost_total",
                            "training steps lost across defrag migrations "
                            "(0 while every move quiesces)", typ="counter")
        g_df_den = m.gauge("tdapi_defrag_denied_total",
                           "defrag runs refused (not blocked / over "
                           "budget / eviction failed)", typ="counter")
        g_df_ms = m.gauge("tdapi_defrag_last_run_ms")

        def collect() -> None:
            tpu = self.tpu.get_status()
            cpu = self.cpu.get_status()
            ports = self.ports.get_status()
            g_chips.set(tpu["freeCount"], state="free")
            g_chips.set(sum(1 for c in tpu["chips"] if c["used"]),
                        state="used")
            g_chips.set(len(tpu["cordoned"]), state="cordoned")
            g_cores.set(cpu["usedCount"], state="used")
            g_cores.set(cpu["totalCount"] - cpu["usedCount"], state="free")
            g_ports.set(ports["availableCount"], state="available")
            g_ports.set(len(ports["usedPortSet"]), state="used")
            g_rs.set(len(self.container_versions.items()))
            g_vols.set(len(self.volume_versions.items()))
            g_wq_pend.set(self.wq.pending())
            g_wq_drop.set(self.wq.dropped_count())
            g_wq_coal.set(self.wq.coalesced_count())
            g_rec.set(self.last_reconcile["actions"])
            g_wal_rec.set(self.store.wal_records)
            g_wal_fl.set(getattr(self.store, "wal_flushes", 0))
            g_wal_flr.set(getattr(self.store, "wal_flushed_records", 0))
            g_wal_max.set(getattr(self.store, "wal_flush_batch_max", 0))
            g_health.set(sum(c["failureScore"]
                             for c in self.health.report()["chips"]))
            g_kills.set(getattr(getattr(self.backend, "inner", self.backend),
                                "stop_kills", 0))
            g_reshards.set(self.replicasets.reshards_total)
            cf = copyfast.METRICS.snapshot()
            g_cp_bytes.set(cf["copyBytes"])
            g_cp_secs.set(cf["copySeconds"])
            g_cp_mode.reset()
            for mode in cf["copiesByMode"]:
                g_cp_mode.set(cf["copiesByMode"][mode], mode=mode)
            g_downtime.set(cf["lastDowntimeMs"])
            g_delta.set(cf["deltaFiles"])
            # per-chip lines only for chips actually share-split /
            # regulated, so the exposition stays bounded on big slices;
            # reset() drops series for chips that since emptied
            total_q = SHARE_QUANTA * len(tpu["chips"])
            alloc_q = sum(sum(c["shares"].values()) for c in tpu["chips"])
            g_sh.reset()
            for c in tpu["chips"]:
                if c["shares"]:
                    g_sh.set(sum(c["shares"].values()), chip=c["index"])
            g_sh_tot.set(alloc_q)
            g_sh_free.set(tpu.get("freeShares", 0))
            g_sh_util.set(round(alloc_q / total_q, 6) if total_q else 0)
            for g in (g_reg_q, g_reg_pre, g_reg_ch, g_reg_t):
                g.reset()
            for r in regulator.snapshot():
                g_reg_q.set(r["queueDepth"], chip=r["chip"])
                g_reg_pre.set(r["preemptTotal"], chip=r["chip"])
                g_reg_ch.set(r["chunksTotal"], chip=r["chip"])
                g_reg_t.set(len(r["tenants"]), chip=r["chip"])
            gate = self.gate.describe()
            g_mut_in.set(gate["inflight"])
            g_mut_wait.set(gate["waiting"])
            g_mut_adm.set(gate["admittedTotal"])
            g_mut_shed.set(gate["shedTotal"])
            g_idem.set(self.idempotency.record_count())
            g_idem_rep.set(self.idempotency.replays)
            if guarded:
                brk = self.backend.breaker.describe()
                g_brk.set(breaker_gauge(brk["state"]))
                g_brk_f.set(brk["consecutiveFailures"])
            g_traces.set(self.traces.stats()["retained"])
            arb = self.fleet.arbiter
            g_fed_mem.set(len(arb.members()))
            g_fed_gr.set(len(arb.grants()))
            g_fed_own.set(len(self.fleet.member.owned)
                          if self.fleet.member is not None else 0)
            g_fed_renew.set(arb.renewals_total)
            g_fed_steal.set(arb.steals_total)
            g_fed_exp.set(arb.expiries_total)
            g_fed_wev.set(self.hub.events_total)
            g_fed_whead.set(self.hub.head)
            pl = self.placer.describe()
            g_pl_pol.reset()
            g_pl_pol.set(1 if self.placement_policy else 0,
                         policy=pl["policy"])
            g_pl_pools.set(len(pl["pools"]))
            for g in (g_pl_free, g_pl_box, g_pl_frag):
                g.reset()
            for p in pl["pools"]:
                g_pl_free.set(p["freeChips"], pool=p["name"])
                g_pl_box.set(p["largestFreeBox"], pool=p["name"])
                g_pl_frag.set(p["fragmentation"], pool=p["name"])
            g_pl_scored.set(pl["scoredTotal"])
            g_pl_placed.set(pl["placementsTotal"])
            df = self.defrag.describe()
            g_df_runs.set(df["runsTotal"])
            g_df_migs.set(df["migrationsTotal"])
            g_df_moved.set(df["movedChipsTotal"])
            g_df_lost.set(df["stepsLostTotal"])
            g_df_den.set(df["deniedTotal"])
            g_df_ms.set(df["lastRunMs"])
            if self.replicator is not None:
                rs = self.replicator.describe()
                g_repl_hor.set(rs["horizon"])
                g_repl_lag.set(rs["lagRevisions"])
                g_repl_ev.set(rs["eventsApplied"])
                g_repl_rs.set(rs["resyncs"])
                g_repl_con.set(1 if rs["connected"] else 0)
            else:
                for g in (g_repl_hor, g_repl_lag, g_repl_ev, g_repl_rs,
                          g_repl_con):
                    g.set(0)
            for g in (g_gw_rep, g_gw_q, g_gw_in, g_gw_req, g_gw_shed,
                      g_gw_scale, g_gw_aff, g_gw_aff_tok, g_kv_blocks,
                      g_kv_handoff, g_gw_eject, g_gw_hedge,
                      g_gw_hedge_win, g_gw_rb, g_wk_req, g_wk_shed,
                      g_wk_dead, g_wk_retry):
                g.reset()
            # worker-tier counts fold into the SAME gateway families the
            # in-process router feeds (metric-family parity: a dashboard
            # sum over tdapi_gateway_requests_total is the whole data
            # plane, whichever tier served it)
            tier = self.workers
            tier_desc = tier.describe() if tier is not None else None
            tier_gw = (tier_desc or {}).get("gateways", {})
            for gw in self.gateways.snapshot():
                name = gw["name"]
                by_state: dict[str, int] = {}
                for r in gw["replicas"]:
                    by_state[r["state"]] = by_state.get(r["state"], 0) + 1
                for state, count in by_state.items():
                    g_gw_rep.set(count, gateway=name, state=state)
                wk = tier_gw.get(name, {})
                g_gw_q.set(gw["queueDepth"] + wk.get("queued", 0),
                           gateway=name)
                g_gw_in.set(gw["inflight"] + wk.get("inflight", 0),
                            gateway=name)
                g_gw_req.set(gw["requestsTotal"]
                             + wk.get("requestsTotal", 0), gateway=name)
                g_gw_shed.set(gw["shedTotal"] + wk.get("shedTotal", 0),
                              gateway=name)
                g_gw_scale.set(gw["scaleUps"], gateway=name,
                               direction="up")
                g_gw_scale.set(gw["scaleDowns"], gateway=name,
                               direction="down")
                g_gw_aff.set(gw.get("affinityHits", 0)
                             + wk.get("affinityHits", 0), gateway=name)
                g_gw_aff_tok.set(gw.get("affinityTokens", 0)
                                 + wk.get("affinityTokens", 0),
                                 gateway=name)
                g_kv_handoff.set(gw.get("kvHandoffs", 0), gateway=name)
                tt = gw.get("tailTolerance", {})
                g_gw_eject.set(tt.get("ejections", 0), gateway=name)
                g_gw_hedge.set(tt.get("hedges", 0)
                               + wk.get("hedges", 0), gateway=name)
                g_gw_hedge_win.set(tt.get("hedgeWins", 0)
                                   + wk.get("hedgeWins", 0),
                                   gateway=name)
                g_gw_rb.set(tt.get("retryBudgetExhausted", 0)
                            + wk.get("retryBudgetExhausted", 0),
                            gateway=name)
                for r in gw["replicas"]:
                    if r.get("kvOcc"):
                        g_kv_blocks.set(r["kvOcc"], gateway=name,
                                        replica=r["name"])
            if tier_desc is not None:
                g_wk_alive.set(tier_desc["alive"])
                g_wk_respawn.set(tier_desc["respawns"])
                for name, rows in tier.per_worker_counts().items():
                    for w, row in enumerate(rows):
                        if not any(row.values()):
                            continue    # bounded exposition: quiet cells
                        g_wk_req.set(row["requests"], worker=w,
                                     gateway=name)
                        g_wk_shed.set(row["shed"], worker=w,
                                      gateway=name)
                        g_wk_dead.set(row["deadline"], worker=w,
                                      gateway=name)
                        g_wk_retry.set(row["retries"], worker=w,
                                       gateway=name)
            else:
                g_wk_alive.set(0)
                g_wk_respawn.set(0)
            with self._stream_lock:
                g_followers.set(self._stream_clients)

        m.collector(collect)
        return m

    def h_metrics(self, req: Request) -> Response:
        """Prometheus text exposition — the pull-metrics surface the
        reference lacks (SURVEY §5.5: 'No Prometheus'). Rendered by the
        obs/metrics.py registry (App-local inventories first, then the
        process-global latency histograms), with label-value escaping and
        the exposition-format content type."""
        body = self.metrics.render() + obs_metrics.REGISTRY.render()
        return RawResponse(body.encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")

    _openapi_bytes: Optional[bytes] = None

    def h_openapi(self, req: Request) -> Response:
        """Serve the shipped OpenAPI document (reference distributes
        api/gpu-docker-api-en.openapi.json as a file; here it is also an
        endpoint). Read once, served from memory thereafter."""
        if self._openapi_bytes is None:
            spec = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                "api", "openapi.json")
            try:
                with open(spec, "rb") as f:
                    self._openapi_bytes = f.read()
            except OSError:
                return err(ResCode.ServerBusy)
        return RawResponse(self._openapi_bytes)

    def h_res_tpus(self, req: Request) -> Response:
        return ok({"tpus": self.tpu.get_status()})

    def h_res_cpus(self, req: Request) -> Response:
        return ok({"cpus": self.cpu.get_status()})

    def h_res_ports(self, req: Request) -> Response:
        return ok({"ports": self.ports.get_status()})

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.server.start()
        if self.workers is not None:
            self.workers.start()
        if self._fleet_member_id:
            # configured here, not __init__: the advertised address is
            # the port the server just bound
            self.fleet.configure_member(
                self._fleet_member_id, addr=self.address,
                host=self._fleet_host, api_key=self._api_key,
                adopt=self._fleet_adopt, promote=self._fleet_promote)
            self.fleet.start()
        if self.replicator is not None:
            self.replicator.start()
        self._start_store_maintenance()
        self.health.start()   # no-op when health_interval <= 0
        # background defrag loop: retries gang shapes the admission path
        # noted as fragmentation-blocked (no-op when interval <= 0)
        self.defrag.start(self._defrag_interval)
        log.info("tpu-docker-api (PyTorch port) listening on %s:%d "
                 "(%d cards, backend ready)", self.server.host,
                 self.server.port, self.tpu.topology.num_chips)

    # ------------------------------------------------- store maintenance

    def maintain_store(self) -> dict:
        """One maintenance pass: compact history below the current revision
        (container/volume/version history prefixes kept in full) and rewrite
        the WAL. Safe to call any time; also runs automatically when the WAL
        crosses store_maint_records."""
        from ..store.client import KEEP_HISTORY_PREFIXES
        stats = self.store.maintain(KEEP_HISTORY_PREFIXES)
        stats["idempotencySwept"] = self.idempotency.sweep()
        log.info("store maintenance: dropped %d revisions, WAL now %d records",
                 stats["dropped"], stats["wal_records"])
        return stats

    def _start_store_maintenance(self) -> None:
        if self.store_maint_records <= 0:
            return
        self._maint_stop = threading.Event()

        def loop():
            while not self._maint_stop.wait(2.0):
                try:
                    if self.store.wal_records >= self.store_maint_records:
                        self.maintain_store()
                except Exception:  # noqa: BLE001 — keep the janitor alive
                    log.exception("store maintenance failed")

        self._maint_thread = threading.Thread(
            target=loop, name="store-maint", daemon=True)
        self._maint_thread.start()

    def stop(self) -> None:
        """Graceful shutdown: drain queue, flush all state (reference Stop,
        main.go:139-154)."""
        self.server.stop()
        # leave the fleet while the store (local arbiter) / the host
        # daemon (remote) is still reachable: a graceful exit releases
        # this member's grants instead of waiting out the TTL
        self.fleet.stop()
        if self.replicator is not None:
            # after fleet.stop(): a takeover mid-shutdown must still be
            # able to promote from the replica
            self.replicator.stop()
        if self.workers is not None:
            # the module-global latency family must not keep scraping a
            # dead tier's unlinked segment (and a later App's tier will
            # install its own hook)
            if (obs_metrics.GATEWAY_LATENCY._extern
                    == self.workers.latency_extern):
                obs_metrics.GATEWAY_LATENCY.set_extern(None)
            self.workers.stop()    # drain the data-plane tier first
        self.gateways.stop_all()   # autoscaler loops, before services go
        self.defrag.stop()         # before services: a mid-run migrate
                                   # must not race the queue close
        self.health.stop()
        if self._maint_stop is not None:
            # join, don't just signal: an in-flight maintain() racing past
            # store.close() would os.replace() its snapshot over a WAL a
            # successor App may already be appending to (lost writes)
            self._maint_stop.set()
            self._maint_thread.join(timeout=10)
        self.wq.close()
        for sch in (self.tpu, self.cpu, self.ports):
            sch.flush()
        self.container_versions.flush()
        self.volume_versions.flush()
        self.merges.flush()
        if self.store_maint_records > 0:
            try:
                self.maintain_store()   # leave a bounded WAL at rest
            except Exception:  # noqa: BLE001
                log.exception("final store maintenance failed")
        self.backend.close()
        self.events.close()
        self.traces.close()
        self.store.close()
        # last: the daemon's own postmortem segment (SIGTERM reaches
        # here through the cli handler; a SIGKILL'd daemon leaves the
        # previous flush — telemetry, not state)
        self.recorder.note("stop")
        self.recorder.flush_to(os.path.join(self.state_dir,
                                            "recorder-daemon.json"))

    @property
    def address(self) -> str:
        return f"{self.server.host}:{self.server.port}"
