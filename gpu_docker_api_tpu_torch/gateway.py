"""Inference gateway: continuous-batching router + CoW-clone autoscaler.

The port's copy of the JAX control plane's gateway.py, over the card
scheduler (`parse_gpu_count`; the `tpuCount` field and the stored
`tpu_chips` keep JAX's names). It imports no torch: the replicas are
processes that speak the serving contract (the port's workloads/serve.py,
or workloads/mock_model.py on the CPU).

The serving control loop for "model X, heavy traffic, stay under SLO":

- a **router** fronting N model-serving replicas: requests admit into a
  replica's continuous batcher the moment it has a free slot
  (admit-on-slot-free — the gateway tracks per-replica in-flight against
  the slot count each replica advertises at readiness), routed
  least-queued, with a per-request deadline and bounded-queue shedding
  (429 + Retry-After) so overload degrades by refusing early, never by
  collapsing tail latency (Orca's continuous batching, AlpaServe's
  serve-under-SLO framing);
- an **autoscaler** control loop reacting to queue depth and rolling p99:
  scale-up clones a warm replica's writable layer via the copyfast
  reflink ladder into the new container before start — the new
  replica skips model load / compile and is serving well under the ~1.9s
  cold start — scale-down stops idle replicas (grants released, layer
  kept), and scale-to-zero re-admits through the warm pool + the stopped
  replica's kept layer on the first request (the wake path);
- **multiplexing**: replicas may hold fractional card grants, so
  several small models share a card through the share ledger + regulator;
  placement spreads ONE gateway's replicas across cards (soft
  anti-affinity — apply_shares `avoid`) while different gateways pack.

Scale mutations are intent-journaled like every mutation: scale-up is a
`gateway.scale` intent wrapping the replica's own journaled `run` (with
its `cloned` step and the gwscale.after_clone crashpoint); a crash
mid-scale unwinds the half-made replica at boot exactly like an aborted
run, and the gateway's replica roster is re-derived from stored container
records (adopt-by-name), so there is no separate roster state to corrupt.

The DATA PLANE (`POST /api/v1/gateways/{name}/generate`) bypasses the
mutation admission gate and idempotency middleware — serving traffic is
not a control mutation; the gateway applies its own admission policy.

No counterpart in the reference Go service (it schedules opaque
containers and never routes to them).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import queue
import re
import socket
import threading
import time
import uuid

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import faults, kvaffinity, tailtolerance, xerrors
from .dtos import ContainerRun
from .intents import KIND_GATEWAY
from .obs import metrics as obs_metrics
from .obs import trace
from .schedulers import parse_gpu_count

log = logging.getLogger(__name__)

GATEWAYS = "gateways"
CONTAINERS = "containers"

#: replica replicaSet naming: f"{gateway}r{idx}" — dashless (the API's
#: name rule) and recoverable by scan (adopt-by-name at boot)
_REPLICA_RE = "r(\\d+)$"

# replica states
STARTING = "starting"    # container up, readiness probe not yet green
READY = "ready"          # serving; claims admit into it
STOPPING = "stopping"    # scale-down picked it; claims skip it
STOPPED = "stopped"      # grants released, layer kept (warm re-admission)
FAILED = "failed"        # transport failures exhausted its budget


def replica_names_for(client, gateway: str) -> list[str]:
    """Stored replicaSet names belonging to `gateway`, by name shape —
    the roster's source of truth at boot and in the delete replay."""
    pat = re.compile(re.escape(gateway) + _REPLICA_RE)
    out = []
    for kv in client.range(CONTAINERS):
        name = kv.key.rsplit("/", 1)[1]
        if pat.fullmatch(name):
            out.append(name)
    return sorted(out)


@dataclass
class GatewayConfig:
    """One gateway's persisted configuration (store resource `gateways`)."""
    name: str = ""
    image: str = ""
    cmd: list = field(default_factory=list)
    env: list = field(default_factory=list)
    tpuCount: float = 0          # per replica; fractional = multiplexing
    cpuCount: int = 0
    memory: str = ""
    priority: str = ""           # regulator class for fractional replicas
    port: str = "8000"           # containerPort the replica serves on
    minReplicas: int = 1
    maxReplicas: int = 4
    sloMs: float = 1000.0        # p99 target the autoscaler defends
    deadlineMs: float = 10000.0  # per-request deadline at the gateway
    maxQueue: int = 64           # gateway admission queue bound (shed past it)
    scaleUpQueue: int = 4        # queued-per-ready-replica that triggers scale
    scaleDownIdleS: float = 60.0
    slots: int = 4               # assumed per-replica slots until healthz says
    readiness: str = "http"      # "http" (poll /healthz) | "running" (inspect)
    readyTimeoutS: float = 30.0  # starting -> failed after this
    cooldownS: float = 1.0       # min gap between scale decisions
    # "shared": every replica serves whole requests. "disaggregated":
    # replicas split by idx parity into a prefill pool (even) and a
    # decode pool (odd); long-prompt requests prefill on one pool, the
    # prompt KV hands off via the replica's /kv export, and decode runs
    # on the other — parity (not a stored role field) so adopt-by-name
    # recovers each replica's pool from its name alone after a crash
    poolPolicy: str = "shared"

    def to_json(self) -> dict:
        return {
            "name": self.name, "image": self.image, "cmd": list(self.cmd),
            "env": list(self.env), "tpuCount": self.tpuCount,
            "cpuCount": self.cpuCount, "memory": self.memory,
            "priority": self.priority, "port": self.port,
            "minReplicas": self.minReplicas,
            "maxReplicas": self.maxReplicas, "sloMs": self.sloMs,
            "deadlineMs": self.deadlineMs, "maxQueue": self.maxQueue,
            "scaleUpQueue": self.scaleUpQueue,
            "scaleDownIdleS": self.scaleDownIdleS, "slots": self.slots,
            "readiness": self.readiness,
            "readyTimeoutS": self.readyTimeoutS,
            "cooldownS": self.cooldownS,
            "poolPolicy": self.poolPolicy,
        }

    @classmethod
    def from_json(cls, d: dict) -> "GatewayConfig":
        cfg = cls()
        for k in cfg.to_json():
            if k in d and d[k] is not None:
                setattr(cfg, k, d[k])
        cfg.cmd = list(cfg.cmd or [])
        cfg.env = list(cfg.env or [])
        cfg.port = str(cfg.port)
        return cfg

    def validate(self) -> None:
        if not self.name:
            raise ValueError("gateway name cannot be empty")
        if "-" in self.name:
            raise ValueError("gateway name cannot contain dash")
        if not self.image:
            raise ValueError("image cannot be empty")
        parse_gpu_count(self.tpuCount)          # raises on bad fractions
        if self.minReplicas < 0:
            raise ValueError("minReplicas must be >= 0")
        if self.maxReplicas < 1 or self.maxReplicas < self.minReplicas:
            raise ValueError("maxReplicas must be >= max(1, minReplicas)")
        if self.deadlineMs <= 0 or self.sloMs <= 0:
            raise ValueError("deadlineMs and sloMs must be > 0")
        if self.maxQueue < 1:
            raise ValueError("maxQueue must be >= 1")
        if self.readiness not in ("http", "running"):
            raise ValueError("readiness must be 'http' or 'running'")
        if self.poolPolicy not in ("shared", "disaggregated"):
            raise ValueError(
                "poolPolicy must be 'shared' or 'disaggregated'")


class Replica:
    """One replica's control-plane handle. Mutable fields are guarded by
    the owning Gateway's condition."""

    def __init__(self, name: str, idx: int):
        self.name = name              # replicaSet name ({gw}r{idx})
        self.idx = idx
        self.container = ""           # current container ({name}-{version})
        self.host_port = 0
        self.chips: list[int] = []
        self.state = STARTING
        self.slots = 1
        self.inflight = 0
        self.failures = 0
        self.started_at = 0.0         # scale trigger time (ready latency)
        self.ready_at = 0.0
        # KV affinity state, refreshed from the replica's response
        # headers: its advertised prefix Bloom sketch + cached-block
        # occupancy (kvaffinity module); last_hit is the sketch hit the
        # most recent scored pick credited to this replica
        self.kv_occ = 0
        self.kv_sketch: Optional[list] = None
        self.last_hit = 0

    @property
    def role(self) -> str:
        """Pool under poolPolicy=disaggregated, derived from idx PARITY
        (even=prefill, odd=decode) so a crash-rebuilt roster (adopt-by-
        name) recovers pool membership with no stored role state."""
        return "prefill" if self.idx % 2 == 0 else "decode"

    def describe(self) -> dict:
        return {
            "name": self.name, "container": self.container,
            "hostPort": self.host_port, "state": self.state,
            "slots": self.slots, "inflight": self.inflight,
            "chips": list(self.chips), "failures": self.failures,
            "role": self.role, "kvOcc": self.kv_occ,
        }


def _http_transport(port: int, method: str, path: str, body: bytes,
                    timeout: float) -> tuple[int, bytes]:
    """One replica HTTP call on a fresh connection. The forward path
    keeps per-thread pooled connections (below); this is the probe /
    fallback transport."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Gateway:
    """Router + autoscaler for one gateway. The condition guards the
    replica roster, the admission FIFO, and the counters; every backend /
    store / replica-HTTP call happens outside it."""

    #: forward failures before a replica is marked FAILED
    MAX_FAILURES = 3
    #: autoscaler tick — also the readiness-probe cadence, so it bounds
    #: the detection half of scale->ready latency (50ms keeps the whole
    #: clone path's p50 well under the 500ms criterion; the tick body is
    #: a lock-snapshot + at most one healthz probe, so idle cost is ~0)
    TICK_S = 0.05

    def __init__(self, cfg: GatewayConfig, services, intents, events=None,
                 traces=None, transport: Optional[Callable] = None,
                 on_change: Optional[Callable] = None):
        self.cfg = cfg
        self._svc = services
        self._intents = intents
        self.events = events
        self.traces = traces
        # injectable for unit tests / the perf floor; None = real HTTP
        self._transport = transport
        # router-state change hook: the multi-process worker tier
        # (server/workers.py) republishes the shared-memory roster twin
        # when replicas turn ready/stopped/failed or config changes. The
        # callback must be cheap and non-blocking (it sets an event).
        self.on_change = on_change
        self._cond = threading.Condition()
        # one scale operation at a time per gateway: the autoscaler
        # thread, a manual PATCH scale, and create's min-replica top-up
        # may otherwise race _next_idx()/stopped-replica selection and
        # double-mint the same replica name (coarse op mutex, same
        # pattern as the services' per-name _mutex; the data plane never
        # takes it)
        self._scale_mutex = threading.Lock()
        self.replicas: dict[str, Replica] = {}
        # two admission classes, mirroring the regulator's: the high
        # (latency) FIFO is served strictly first; best-effort requests
        # keep FIFO order among themselves
        self._fifo: deque = deque()
        self._fifo_hi: deque = deque()
        self._queued = 0
        # per-thread pooled replica connections: {(thread, port): conn}
        self._local = threading.local()
        # rolling latency window for the autoscaler's p99 signal
        self._lat: deque = deque(maxlen=2048)
        self._last_request = time.monotonic()
        self._last_scale = 0.0
        self._wake_pending = 0.0      # monotonic stamp of a wake trigger
        self.requests_total = 0
        self.shed_total = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # KV-aware routing: prefix-affinity scoring on by
        # default (TDAPI_GW_AFFINITY=0 restores pure least-queued — the
        # paired bench's baseline arm), prompt-length bar for the
        # disaggregated prefill/decode split, and its counters
        self._affinity = os.environ.get("TDAPI_GW_AFFINITY", "1") != "0"
        self._disagg_prompt = int(os.environ.get(
            "TDAPI_GW_DISAGG_PROMPT", "64"))
        self.affinity_hits = 0
        self.affinity_tokens = 0
        self.kv_handoffs = 0
        self._affinity_event_at = 0.0  # router.affinity_hit rate limit
        self.last_scale_ready_ms: Optional[float] = None
        # trigger->READY latencies, newest last (bench/status: the event
        # ring under load evicts faster than a run can read it back)
        self.ready_hist: deque = deque(maxlen=64)
        # tail tolerance: gray-failure ejection + probation,
        # hedged requests, and the retry budget — three policy objects
        # (tailtolerance module) separable from this transport, each
        # with its own kill switch. The latency store starts local; the
        # worker tier swaps in its shm-backed twin so both tiers fold
        # into, and decide from, the SAME published digests.
        self._eject_on = tailtolerance.knob(tailtolerance.EJECT_ENV)
        self._hedge_on = tailtolerance.knob(tailtolerance.HEDGE_ENV)
        self._retry_budget_on = tailtolerance.knob(
            tailtolerance.RETRY_BUDGET_ENV)
        self.lat_store = tailtolerance.LocalLatencyStore()
        self.probation = tailtolerance.ProbationTracker()
        self.hedge = tailtolerance.HedgePolicy()
        self.retry_budget = tailtolerance.RetryBudget()
        self._fleet_median_ms: Optional[float] = None
        self.ejections = 0
        self.probation_passes = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.retry_budget_exhausted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ helpers

    def _record(self, op: str, **kw) -> None:
        if self.events is not None:
            self.events.record(op, target=self.cfg.name, **kw)

    def _changed(self) -> None:
        """Fire the router-state change hook (never under _cond — the
        worker tier's poke only sets an event, but keep the contract
        lock-free anyway)."""
        if self.on_change is not None:
            try:
                self.on_change()
            except Exception:  # noqa: BLE001 — a broken publisher hook must not fail the transition that fired it
                log.exception("gateway %s on_change hook", self.cfg.name)

    def router_state(self) -> dict:
        """The router's STATE, split from its policy: everything the
        admission path needs to route — config bounds and the live
        replica roster — as plain data. The worker tier publishes this
        into the shared-memory segment; the policy (admit-on-slot-free,
        least-queued, priority FIFO, shed) runs against it in every
        worker process without touching this object."""
        with self._cond:
            reps = sorted(self.replicas.values(), key=lambda r: r.idx)
            return {
                "name": self.cfg.name,
                "maxQueue": int(self.cfg.maxQueue),
                "deadlineMs": float(self.cfg.deadlineMs),
                "replicas": [{"port": int(r.host_port),
                              "slots": int(r.slots),
                              "ready": r.state is READY}
                             for r in reps],
            }

    def note_external_demand(self) -> None:
        """Scale-to-zero wake for traffic that never touches forward():
        the worker tier observed data-plane requests while no replica is
        live, so arm the wake trigger the autoscaler acts on."""
        wake = False
        with self._cond:
            alive = any(r.state in (READY, STARTING)
                        for r in self.replicas.values())
            if not alive and not self._wake_pending:
                self._wake_pending = time.monotonic()
                self._last_request = time.monotonic()
                wake = True
        if wake:
            self._record("gateway.wake")

    def _call(self, port: int, method: str, path: str, body: bytes,
              timeout: float, headers: Optional[dict] = None,
              meta: Optional[dict] = None) -> tuple[int, bytes]:
        """`headers` adds outbound headers (the disaggregation handoff's
        X-TDAPI-Phase / X-TDAPI-KV-*); `meta`, when a dict, is populated
        with the response's X-TDAPI-* headers (lowercased keys). Injected
        transports keep the plain 5-arg contract — they may return an
        optional third element (a dict) that lands in `meta`."""
        if self._transport is not None:
            out = self._transport(port, method, path, body, timeout)
            if meta is not None and len(out) > 2 and out[2]:
                meta.update(out[2])
            return out[0], out[1]
        # pooled keep-alive connection per (handler thread, replica port):
        # the forward path must not pay TCP handshake + slow start per
        # request (the router-overhead criterion prices exactly this)
        pool = getattr(self._local, "conns", None)
        if pool is None:
            pool = self._local.conns = {}
        conn = pool.get(port)
        try:
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=timeout)
                # http.client writes headers and body as separate
                # segments: without NODELAY, Nagle holds the body until
                # the replica ACKs the headers — tens of ms on a path
                # whose whole budget is one decode step
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                pool[port] = conn
            else:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            hdrs = {"Content-Type": "application/json"}
            if headers:
                hdrs.update(headers)
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            payload = resp.read()
            if meta is not None:
                for k, v in resp.getheaders():
                    if k.lower().startswith("x-tdapi-"):
                        meta[k.lower()] = v
            return resp.status, payload
        except Exception:
            # never reuse a connection in an unknown state
            pool.pop(port, None)
            if conn is not None:
                try:
                    conn.close()
                # tdlint: disable=silent-swallow -- closing an already-failed socket; the original error re-raises
                except Exception:  # noqa: BLE001 — best-effort close
                    pass
            raise

    def p99_ms(self, window_s: float = 30.0) -> Optional[float]:
        now = time.monotonic()
        with self._cond:
            vals = sorted(ms for t, ms in self._lat if now - t <= window_s)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    # ------------------------------------------------------- the router

    @staticmethod
    def _prompt_tokens(body: bytes) -> Optional[list]:
        """The request's (flat) prompt token list, or None when the body
        has no parseable tokens — affinity hashing and the disaggregation
        length bar both read it; a malformed body returns None here and
        fails with the replica's own 400 later."""
        try:
            tokens = json.loads(body).get("tokens")
        except (ValueError, AttributeError):
            return None
        if (isinstance(tokens, list) and tokens
                and isinstance(tokens[0], list)):
            tokens = tokens[0]                # [batch, len] request shape
        return tokens if isinstance(tokens, list) else None

    def _note_replica_kv(self, r: Replica, meta: dict) -> None:
        """Fold a response's advertised prefix sketch + KV occupancy
        (X-TDAPI-KV-Sketch / X-TDAPI-KV-Occ) into the replica handle —
        the in-process twin of the worker tier's shm kv cells."""
        words = kvaffinity.decode_sketch_hex(
            meta.get("x-tdapi-kv-sketch") or "")
        if words is None:
            return
        try:
            occ = int(meta.get("x-tdapi-kv-occ") or 0)
        except ValueError:
            occ = 0
        with self._cond:
            r.kv_sketch = words
            r.kv_occ = occ

    def forward(self, body: bytes, stream: bool = False,
                priority: str = ""):
        """Route one generate request: admit when a ready replica has a
        free batcher slot (FIFO — a burst can't starve early arrivals),
        forward with the remaining deadline, relay the reply. Raises
        GatewayShedError (queue bound) or GatewayDeadlineError (deadline
        passed while waiting); transport failures retry other replicas
        until the deadline.

        priority "high"/"latency" admits through the strict-priority
        FIFO: an SLO-bound stream keeps its p99 while best-effort burst
        traffic queues behind it (the gateway-level twin of the
        regulator's latency class).

        stream=True returns (status, chunk-iterator) relaying the
        replica's body as it arrives instead of buffering it."""
        t0 = time.monotonic()
        deadline = t0 + self.cfg.deadlineMs / 1e3
        wake = False
        with self._cond:
            self.requests_total += 1
            self._last_request = t0
            alive = any(r.state in (READY, STARTING)
                        for r in self.replicas.values())
            if not alive and not self._wake_pending:
                self._wake_pending = t0      # scale-to-zero wake trigger
                wake = True
        if wake:
            self._record("gateway.wake")
        high = priority in ("high", "latency")
        tokens = hashes = None
        if self._affinity or self.cfg.poolPolicy == "disaggregated":
            tokens = self._prompt_tokens(body)
        if self._affinity and tokens:
            try:
                hashes = kvaffinity.chunk_hashes(tokens) or None
            except (TypeError, ValueError):
                hashes = None
        if (self.cfg.poolPolicy == "disaggregated" and not stream
                and tokens is not None
                and len(tokens) >= self._disagg_prompt):
            out = self._forward_disagg(body, tokens, hashes, deadline,
                                       t0, high)
            if out is not None:
                return out
            # fall through: pools not split yet, prefill failed, or the
            # request is unsuitable — the shared path serves it whole
        hedge_delay = None
        if self._hedge_on and not stream:
            try:
                hedge_delay = self.hedge.delay_s(self.lat_store.snapshot)
            # tdlint: disable=silent-swallow -- the store may be mid-swap at worker-tier teardown; no delay just means no hedge
            except Exception:  # noqa: BLE001
                hedge_delay = None
        while True:
            r = self._claim(deadline, high=high, hashes=hashes)
            if r.last_hit > 0:
                now = time.monotonic()
                if now - self._affinity_event_at > 5.0:
                    # rate-limited: one ring entry per burst, not per
                    # request — counters carry the totals
                    self._affinity_event_at = now
                    self._record("router.affinity_hit", replica=r.name,
                                 hitTokens=r.last_hit)
            if stream and self._transport is None:
                left = deadline - time.monotonic()
                resp = self._request_stream(r.host_port, body,
                                            max(left, 0.05))
                # the slot stays claimed while the body relays; the
                # generator releases it (and prices the latency) on
                # completion or client disconnect
                return resp.status, self._relay(r, resp, t0)
            if hedge_delay is not None and self.hedge.peek():
                out = self._forward_hedged(r, body, deadline,
                                           hedge_delay, t0)
            else:
                out = self._forward_one(r, body, deadline, t0)
            if isinstance(out, BaseException):
                if time.monotonic() >= deadline:
                    raise xerrors.GatewayDeadlineError(
                        f"{self.cfg.name}: replicas unreachable "
                        f"({type(out).__name__})")
                # retry budget, not retry-until-deadline: a brownout
                # that exhausts the bucket sheds 503 + Retry-After
                # instead of multiplying its own load
                if (self._retry_budget_on
                        and not self.retry_budget.try_retry()):
                    with self._cond:
                        self.retry_budget_exhausted += 1
                    raise xerrors.GatewayRetryBudgetError(
                        f"{self.cfg.name}: retry budget exhausted "
                        f"({type(out).__name__})")
                continue                     # another replica, same FIFO
            status, payload = out
            self.retry_budget.success()
            self.hedge.feed()
            if stream:
                # injected transports (tests, perf floor) are buffered
                # by contract: relay the whole payload as one chunk
                return status, iter((payload,))
            return status, payload

    def _forward_one(self, r: Replica, body: bytes, deadline: float,
                     t0: float):
        """One un-hedged replica attempt. Returns (status, payload), or
        the exception when the replica failed (the caller owns the
        retry/shed decision). Folds the SERVICE time (post-claim, so
        admission queueing never pollutes the gray-failure signal) into
        the fleet latency digest on success."""
        meta: dict = {}
        t_send = time.monotonic()
        try:
            status, payload = self._call(
                r.host_port, "POST", "/generate", body,
                timeout=max(deadline - time.monotonic(), 0.05),
                meta=meta)
        # tdlint: disable=silent-swallow -- not swallowed: the exception is RETURNED and the retry loop records/raises it
        except Exception as e:  # noqa: BLE001 — replica gone/slow
            self._release(r, error=True)
            return e
        svc_ms = (time.monotonic() - t_send) * 1e3
        if meta:
            self._note_replica_kv(r, meta)
        ms = (time.monotonic() - t0) * 1e3
        self._release(r, latency_ms=ms, service_ms=svc_ms)
        obs_metrics.GATEWAY_LATENCY.observe(ms, gateway=self.cfg.name)
        return status, payload

    def _pick_other(self, primary: Replica) -> Optional[Replica]:
        """A DIFFERENT healthy ready replica with a free slot, for the
        hedge (least-queued; probation replicas are never hedge targets
        — duplicating onto a suspected-gray replica buys nothing).
        Caller holds _cond and takes the inflight claim itself."""
        best = None
        best_score = 0
        for o in self.replicas.values():
            if o is primary or o.state is not READY:
                continue
            if o.inflight >= o.slots:
                continue
            if self._eject_on and self.probation.contains(o.name):
                continue
            s = kvaffinity.score(0, o.inflight)
            if best is None or s < best_score:
                best, best_score = o, s
        return best

    def _forward_hedged(self, r: Replica, body: bytes, deadline: float,
                        hedge_delay: float, t0: float):
        """Primary attempt plus — if it outlives the fleet-digest hedge
        delay and the token bucket allows — one duplicate on a different
        replica. First completion wins and returns; the losing call
        cannot be cancelled mid-flight, so each attempt thread releases
        ITS OWN claim on completion (release-on-completion IS the
        loser-slot-released contract). The hedge claim is BaseException-
        safe around the hedge.in_flight crashpoint: a crash between
        claim and dispatch leaks no inflight (the sweep pins this).
        Returns (status, payload), or the last exception when every
        attempt failed."""
        results: queue.Queue = queue.Queue()

        def attempt(rep: Replica, is_hedge: bool) -> None:
            meta: dict = {}
            t_send = time.monotonic()
            try:
                status, payload = self._call(
                    rep.host_port, "POST", "/generate", body,
                    timeout=max(deadline - time.monotonic(), 0.05),
                    meta=meta)
            except BaseException as e:  # noqa: BLE001 — the claim must release whatever the transport threw
                self._release(rep, error=True)
                results.put((is_hedge, None, None, e))
                if not isinstance(e, Exception):
                    raise            # injected crashes stay fatal here
                return
            svc_ms = (time.monotonic() - t_send) * 1e3
            if meta:
                self._note_replica_kv(rep, meta)
            ms = (time.monotonic() - t0) * 1e3
            self._release(rep, latency_ms=ms, service_ms=svc_ms)
            obs_metrics.GATEWAY_LATENCY.observe(ms,
                                                gateway=self.cfg.name)
            results.put((is_hedge, status, payload, None))

        threading.Thread(target=attempt, args=(r, False),
                         name=f"gw-{self.cfg.name}-fwd",
                         daemon=True).start()
        in_flight = 1
        first = None
        try:
            first = results.get(timeout=hedge_delay)
        except queue.Empty:
            pass
        if first is None and self.hedge.take():
            with self._cond:
                hr = self._pick_other(r)
                if hr is not None:
                    hr.inflight += 1
            if hr is None:
                self.hedge.put_back()    # nobody to hedge onto
            else:
                try:
                    faults.crashpoint("hedge.in_flight")
                except BaseException:
                    self._release(hr)
                    raise
                with self._cond:
                    self.hedges += 1
                self._record("gateway.hedged", primary=r.name,
                             hedge=hr.name)
                threading.Thread(target=attempt, args=(hr, True),
                                 name=f"gw-{self.cfg.name}-hedge",
                                 daemon=True).start()
                in_flight = 2
        taken = 0
        while True:
            if first is None:
                first = results.get()
            taken += 1
            is_hedge, status, payload, exc = first
            first = None
            if exc is None:
                if is_hedge:
                    with self._cond:
                        self.hedge_wins += 1
                return status, payload
            if taken >= in_flight:
                return exc           # every attempt failed

    def _forward_disagg(self, body: bytes, tokens: list,
                        hashes: Optional[list], deadline: float,
                        t0: float, high: bool):
        """Prefill/decode disaggregation: run the prompt phase on the
        prefill pool (max_new forced to 1 by the X-TDAPI-Phase header;
        the replica exports the prompt KV under this request's key),
        then decode on the decode pool, which pulls the exported KV from
        the prefill replica (X-TDAPI-KV-Source) and continues without
        re-prefilling. The decode response — prompt, first token, and
        the remaining tokens — is byte-compatible with a single-shot
        response, so the client sees one ordinary reply. Returns None to
        fall back to the shared path (pools not split, short budget,
        prefill trouble): the handoff is a throughput fast path, never a
        correctness dependency. Claims release on ALL exits, including
        an injected crash between the phases (BaseException-safe) — the
        orphaned export is then freed by the replica's TTL purge, which
        is the zero-leaked-KV invariant the crash sweep pins."""
        try:
            data = json.loads(body)
            max_new = int(data.get("max_new", 16))
        except (ValueError, TypeError):
            return None
        if max_new < 2:
            return None          # nothing left to decode after handoff
        with self._cond:
            roles = {r.role for r in self.replicas.values()
                     if r.state is READY}
        if roles != {"prefill", "decode"}:
            return None
        key = uuid.uuid4().hex
        pre = self._claim(deadline, high=high, hashes=hashes,
                          pool="prefill")
        dec = None
        lat = None
        try:
            try:
                meta: dict = {}
                status, payload = self._call(
                    pre.host_port, "POST", "/generate", body,
                    timeout=max(deadline - time.monotonic(), 0.05),
                    headers={"X-TDAPI-Phase": "prefill",
                             "X-TDAPI-KV-Key": key}, meta=meta)
                if status != 200:
                    return None
                row = json.loads(payload)["data"]["tokens"][0]
                # replica rows carry prompt + generated tokens; the
                # prefill phase generated exactly one
                if len(row) != len(tokens) + 1:
                    return None
                if meta:
                    self._note_replica_kv(pre, meta)
                faults.crashpoint("kvhandoff.after_prefill")
                dec = self._claim(deadline, high=high, pool="decode")
                data2 = dict(data)
                data2["tokens"] = [row]
                data2["max_new"] = max_new - 1
                meta2: dict = {}
                status2, payload2 = self._call(
                    dec.host_port, "POST", "/generate",
                    json.dumps(data2).encode(),
                    timeout=max(deadline - time.monotonic(), 0.05),
                    headers={"X-TDAPI-KV-Key": key,
                             "X-TDAPI-KV-Source":
                                 f"127.0.0.1:{pre.host_port}"},
                    meta=meta2)
                if status2 != 200:
                    return None
                if meta2:
                    self._note_replica_kv(dec, meta2)
            except (xerrors.GatewayShedError,
                    xerrors.GatewayDeadlineError):
                raise            # admission verdicts stand as-is
            # tdlint: disable=silent-swallow -- handoff is a fast path only: any failure (replica gone, bad row, fetch miss) falls back to the shared full-prefill path, which sheds or raises with the full budget
            except Exception:
                return None
            lat = (time.monotonic() - t0) * 1e3
            obs_metrics.GATEWAY_LATENCY.observe(lat,
                                                gateway=self.cfg.name)
            with self._cond:
                self.kv_handoffs += 1
            self._record("gateway.kv_handoff", prefill=pre.name,
                         decode=dec.name, promptTokens=len(tokens))
            return status2, payload2
        finally:
            self._release(pre)
            if dec is not None:
                self._release(dec, latency_ms=lat)

    def _request_stream(self, port: int, body: bytes, timeout: float):
        """Issue the replica request on this thread's pooled connection
        and return the UNREAD response — `_relay` streams it."""
        pool = getattr(self._local, "conns", None)
        if pool is None:
            pool = self._local.conns = {}
        conn = pool.get(port)
        try:
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=timeout)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                pool[port] = conn
            else:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/json"})
            return conn.getresponse()
        except Exception:
            pool.pop(port, None)
            if conn is not None:
                try:
                    conn.close()
                # tdlint: disable=silent-swallow -- closing an already-failed socket; the original error re-raises
                except Exception:  # noqa: BLE001 — best-effort close
                    pass
            raise

    def _relay(self, r: Replica, resp, t0: float):
        """Yield the replica's body as it arrives. Releases the claimed
        slot in all exits; an early client disconnect (GeneratorExit)
        drops the half-read pooled connection so it can't be reused with
        unread bytes on it."""
        port = r.host_port
        complete = False
        try:
            while True:
                chunk = resp.read(8192)
                if not chunk:
                    complete = True
                    return
                yield chunk
        finally:
            if not complete:
                pool = getattr(self._local, "conns", None) or {}
                conn = pool.pop(port, None)
                if conn is not None:
                    try:
                        conn.close()
                    # tdlint: disable=silent-swallow -- best-effort close of an abandoned half-read connection
                    except Exception:  # noqa: BLE001
                        pass
            ms = (time.monotonic() - t0) * 1e3
            self._release(r, latency_ms=ms)
            obs_metrics.GATEWAY_LATENCY.observe(ms,
                                                gateway=self.cfg.name)

    def _claim(self, deadline: float, high: bool = False,
               hashes: Optional[list] = None,
               pool: Optional[str] = None) -> Replica:
        """Block until a ready replica has slot capacity (strict-priority
        FIFO: the high line drains first, each line FIFO within itself);
        shed on queue bound or deadline. `hashes`/`pool` steer the pick
        (prefix affinity, disaggregation pool) without changing the
        admission contract."""
        with self._cond:
            # fast path: nobody this request would have to queue behind
            # and a slot is free — claim without a ticket (a ticket would
            # serialize every request through a notify_all chain; FIFO
            # fairness only matters once a line exists). High-priority
            # requests only need the HIGH line empty: barging the
            # best-effort line is the priority contract.
            if not self._fifo_hi and (high or not self._fifo):
                r = self._pick(hashes, pool)
                if r is not None:
                    r.inflight += 1
                    return r
            if self._queued >= self.cfg.maxQueue:
                self.shed_total += 1
                raise xerrors.GatewayShedError(
                    f"{self.cfg.name}: admission queue full "
                    f"({self.cfg.maxQueue})")
            ticket = object()
            mine = self._fifo_hi if high else self._fifo
            mine.append(ticket)
            self._queued += 1
            try:
                while True:
                    at_head = mine[0] is ticket and (
                        high or not self._fifo_hi)
                    if at_head:
                        r = self._pick(hashes, pool)
                        if r is not None:
                            r.inflight += 1
                            return r
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self.shed_total += 1
                        raise xerrors.GatewayDeadlineError(
                            f"{self.cfg.name}: no replica slot freed "
                            f"within the {self.cfg.deadlineMs:.0f}ms "
                            f"deadline")
                    # wait for a NOTIFICATION (slot release, replica
                    # turning ready, line movement — every producer
                    # notifies) or this waiter's own deadline. No
                    # periodic re-poll cap: with N parked waiters a 50ms
                    # cap made N/0.05 wakeups/s of pure GIL churn, which
                    # starved the AUTOSCALER thread exactly when a burst
                    # needed it spawning capacity.
                    self._cond.wait(left)
            finally:
                try:
                    mine.remove(ticket)
                except ValueError:
                    pass
                self._queued -= 1
                self._cond.notify_all()

    def _pick(self, hashes: Optional[list] = None,
              pool: Optional[str] = None) -> Optional[Replica]:
        """Affinity-scored ready replica with a free batcher slot — the
        admit-on-slot-free invariant: gateway in-flight per replica never
        exceeds the slot count the replica advertised. Candidates order
        by kvaffinity.score(sketch hit, inflight): with no hashes or no
        sketches this is exactly least-queued (affinity refines the
        order, never overrides a visibly shorter queue). `pool` filters
        to one disaggregation pool by idx parity, degrading to the full
        roster when that pool has no capacity (availability over
        purity).

        Probation (gray-failure ejection) COMPOSES with the affinity
        score rather than filtering: an ejected replica is penalized by
        PENALTY_SCORE, so it serves only when every healthy replica is
        saturated (availability over purity again) — except when its
        trickle probe is due and it sits idle, in which case it wins
        outright (the request IS the probe). FAILED replicas in
        probation are candidates only as due idle probes: that is the
        no-scale-cycle recovery path for transport strikes."""
        eject_on = self._eject_on
        cands = []
        for r in self.replicas.values():
            if r.inflight >= r.slots:
                continue
            if r.state is READY:
                cands.append(r)
            elif (eject_on and r.state is FAILED and r.inflight == 0
                  and self.probation.contains(r.name)
                  and self.probation.probe_due(r.name)):
                cands.append(r)
        if pool is not None:
            pooled = [r for r in cands if r.role == pool]
            if pooled:
                cands = pooled
        best = None
        best_score = best_hit = 0
        best_probe = False
        for r in cands:
            hit = (kvaffinity.hit_tokens(r.kv_sketch, hashes)
                   if hashes else 0)
            s = kvaffinity.score(hit, r.inflight)
            probe = False
            if eject_on and self.probation.contains(r.name):
                if r.inflight == 0 and self.probation.probe_due(r.name):
                    probe = True
                    s -= tailtolerance.PENALTY_SCORE
                else:
                    s += tailtolerance.PENALTY_SCORE
            if best is None or s < best_score:
                best, best_score, best_hit = r, s, hit
                best_probe = probe
        if best is not None:
            best.last_hit = best_hit
            if best_hit > 0:
                self.affinity_hits += 1        # under _cond (callers)
                self.affinity_tokens += best_hit
            if best_probe:
                self.probation.note_probe(best.name)
        return best

    def _release(self, r: Replica, latency_ms: Optional[float] = None,
                 error: bool = False,
                 service_ms: Optional[float] = None) -> None:
        """Release the claimed slot. `service_ms` (post-claim replica
        time, admission queueing excluded) feeds the gray-failure
        latency digest; for a replica in probation the completion is
        also its probe verdict — N consecutive passes re-admit it (and
        heal a transport-strike FAILED back to READY without waiting
        for an autoscaler warm re-admission)."""
        down = False
        readmitted = False
        row = None
        with self._cond:
            r.inflight = max(r.inflight - 1, 0)
            # activity includes COMPLETIONS: stamping only arrivals made
            # a single slow request (e.g. the cold wake) read as a full
            # idle window the instant it finished, and the autoscaler
            # scaled the just-used replica away under the next burst
            self._last_request = time.monotonic()
            in_prob = (self._eject_on
                       and self.probation.contains(r.name))
            if error:
                r.failures += 1
                if in_prob:
                    self.probation.verdict(r.name, ok=False)
                if r.failures >= self.MAX_FAILURES and r.state is READY:
                    r.state = FAILED
                    down = True
                    if self._eject_on:
                        # FAILED is no longer terminal-until-scale: it
                        # heals through the same probation/trickle-probe
                        # path a latency ejection uses
                        self.probation.eject(r.name, kind="failed")
            else:
                r.failures = 0
                if latency_ms is not None:
                    self._lat.append((time.monotonic(), latency_ms))
                if service_ms is not None:
                    # digest row = rank of idx, matching the sorted-by-
                    # idx order router_state() publishes to the workers
                    row = sum(1 for o in self.replicas.values()
                              if o.idx < r.idx)
                if in_prob:
                    ok = (service_ms is None
                          or self._probe_pass(service_ms))
                    if self.probation.verdict(r.name, ok=ok):
                        readmitted = True
                        self.probation_passes += 1
                        r.failures = 0
                        if r.state is FAILED:
                            r.state = READY
            self._cond.notify_all()
        if row is not None and not readmitted:
            try:
                self.lat_store.fold(row, service_ms)
            # tdlint: disable=silent-swallow -- the shm-backed store may be mid-teardown with the worker tier; a dropped sample is noise
            except Exception:  # noqa: BLE001
                pass
        if readmitted:
            if row is not None:
                try:
                    # drop the gray-era history so the next ejection
                    # tick judges the healed replica on fresh samples
                    self.lat_store.reset(row)
                # tdlint: disable=silent-swallow -- same teardown race as the fold above
                except Exception:  # noqa: BLE001
                    pass
            self._record("gateway.probation_pass", replica=r.name)
            self._changed()
        if down:
            self._record("gateway.replica_down", replica=r.name,
                         code=500, failures=r.failures)
            self._changed()

    def _probe_pass(self, service_ms: float) -> bool:
        """A probation probe passes when its service time sits under the
        same bar ejection uses (k × healthy-fleet median p95, floored),
        as cached at the last ejection tick. With no baseline yet, any
        completed request passes — the fleet has nothing to compare
        against."""
        med = self._fleet_median_ms
        if med is None:
            return True
        return service_ms <= max(tailtolerance.EJECT_K * med,
                                 tailtolerance.EJECT_FLOOR_MS)

    # --------------------------------------------------- the autoscaler

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._autoscale_loop,
            name=f"gw-{self.cfg.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _signals(self) -> dict:
        with self._cond:
            by_state: dict[str, list[Replica]] = {}
            for r in self.replicas.values():
                by_state.setdefault(r.state, []).append(r)
            ready = by_state.get(READY, [])
            return {
                "queued": self._queued,
                "ready": list(ready),
                "starting": list(by_state.get(STARTING, [])),
                "stopped": list(by_state.get(STOPPED, [])),
                "failed": list(by_state.get(FAILED, [])),
                "inflight": sum(r.inflight for r in ready),
                "capacity": sum(r.slots for r in ready),
                "idle_s": time.monotonic() - self._last_request,
                "wake": self._wake_pending,
            }

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(self.TICK_S):
            try:
                self._probe_starting()
                self._eval_eject()
                self._decide()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("gateway %s autoscale tick", self.cfg.name)

    def _eval_eject(self) -> None:
        """Gray-failure ejection tick: run tailtolerance.eject_set over
        the fleet latency digests (local, or shm-published when a worker
        tier rebinds the store) and move outliers into probation. The
        worker tier runs the SAME pure function over the SAME shm cells,
        so both tiers make identical ejection decisions with zero daemon
        round-trips."""
        if not self._eject_on:
            return
        try:
            snap = self.lat_store.snapshot()
        # tdlint: disable=silent-swallow -- store mid-swap at worker-tier teardown: skip this tick, the next one sees the rebound store
        except Exception:  # noqa: BLE001
            return
        newly = []
        with self._cond:
            reps = sorted(self.replicas.values(), key=lambda o: o.idx)
            self.probation.prune({o.name for o in reps
                                  if o.state in (READY, FAILED)})
            ready = [(row, o) for row, o in enumerate(reps)
                     if o.state is READY]
            already = frozenset(o.name for _, o in ready
                                if self.probation.contains(o.name))
            stats = [(o.name, snap[row][2], snap[row][0])
                     for row, o in ready if row in snap]
            self._fleet_median_ms = tailtolerance.fleet_median_p95(
                stats, already=already)
            target = tailtolerance.eject_set(stats, already=already,
                                             fleet=len(ready))
            for name in target:
                if self.probation.eject(name, kind="latency"):
                    self.ejections += 1
                    p95 = next(p for n, p, _ in stats if n == name)
                    newly.append((name, p95))
        for name, p95 in newly:
            self._record(
                "gateway.ejected", replica=name, p95Ms=round(p95, 3),
                medianMs=(round(self._fleet_median_ms, 3)
                          if self._fleet_median_ms is not None
                          else None))
        if newly:
            self._changed()

    def _decide(self) -> None:
        s = self._signals()
        now = time.monotonic()
        live = len(s["ready"]) + len(s["starting"])
        if now - self._last_scale < self.cfg.cooldownS and not (
                s["queued"] and live == 0):
            return
        p99 = self.p99_ms()
        # scale UP: wake from zero; queue pressure; or p99 over SLO with
        # every ready slot occupied (more load than capacity)
        reason = None
        if (s["queued"] or s["wake"]) and live == 0:
            reason = "wake"
        elif (live < self.cfg.maxReplicas
              and s["queued"] >= self.cfg.scaleUpQueue * max(len(s["ready"]),
                                                             1)):
            reason = "queue"
        elif (live < self.cfg.maxReplicas and p99 is not None
              and p99 > self.cfg.sloMs and s["capacity"] > 0
              and s["inflight"] >= s["capacity"]):
            reason = "p99"
        elif live < self.cfg.minReplicas:
            reason = "min"
        if reason is not None and live < max(self.cfg.maxReplicas, 1):
            self._last_scale = now
            self.scale_up(reason)
            return
        # scale DOWN: idle past the window, with the READY count alone
        # above the floor — counting starting replicas toward the floor
        # let the loop stop the only SERVING replica while its
        # replacement still booted (observed live: a manual scale-up
        # racing the idle window left zero ready capacity for a second)
        if (s["idle_s"] > self.cfg.scaleDownIdleS and s["queued"] == 0
                and s["inflight"] == 0
                and len(s["ready"]) > self.cfg.minReplicas
                and (len(s["ready"]) > 1 or not s["starting"])):
            pool = s["ready"]
            if self.cfg.poolPolicy == "disaggregated" and len(pool) > 1:
                # shrink the LARGER pool so an idle window never strips
                # one phase bare while the other keeps spare replicas
                n_pre = sum(1 for r in pool if r.idx % 2 == 0)
                want = 0 if n_pre >= len(pool) - n_pre else 1
                pool = [r for r in pool if r.idx % 2 == want] or pool
            victim = max(pool, key=lambda r: r.idx)
            self._last_scale = now
            self.scale_down(victim.name, reason="idle")

    def _probe_starting(self) -> None:
        """Readiness: poll each starting replica (outside the lock); on
        green, learn its slot count and open it to claims."""
        with self._cond:
            starting = [r for r in self.replicas.values()
                        if r.state is STARTING]
        for r in starting:
            ok, slots = self._probe(r)
            if ok:
                ready_ms = (time.monotonic() - r.started_at) * 1e3
                with self._cond:
                    if r.state is not STARTING:
                        # a scale-down/delete raced the probe (the HTTP
                        # round-trip runs outside the lock): the 200 we
                        # saw predates the stop — resurrecting the
                        # replica as READY would route traffic at a dead
                        # port and lose the warm-readmit candidate
                        continue
                    r.state = READY
                    r.ready_at = time.monotonic()
                    if slots:
                        r.slots = slots
                    self._cond.notify_all()
                self.last_scale_ready_ms = ready_ms
                self.ready_hist.append(ready_ms)
                self._changed()
                obs_metrics.GATEWAY_SCALE_READY.observe(
                    ready_ms, gateway=self.cfg.name)
                self._record("gateway.replica_ready", replica=r.name,
                             readyMs=round(ready_ms, 3), slots=r.slots)
            elif (time.monotonic() - r.started_at
                  > self.cfg.readyTimeoutS):
                timed_out = False
                with self._cond:
                    if r.state is STARTING:     # same race guard
                        r.state = FAILED
                        timed_out = True
                if timed_out:
                    self._record("gateway.replica_down", replica=r.name,
                                 code=500, reason="ready_timeout")
                    self._changed()

    def _probe(self, r: Replica) -> tuple[bool, int]:
        """(ready?, advertised slots). readiness="running" trusts the
        substrate's run state (mock backends, no live HTTP); "http" polls
        the replica's /healthz and reads its batching block."""
        if self.cfg.readiness == "running":
            try:
                return (self._svc.backend.inspect(r.container).running,
                        self.cfg.slots)
            # tdlint: disable=silent-swallow -- not-ready IS the result; the loop re-probes every tick, ready-timeout surfaces a never-green replica
            except Exception:  # noqa: BLE001 — probe again next tick
                return False, 0
        try:
            status, payload = self._call(r.host_port, "GET", "/healthz",
                                         b"", timeout=0.5)
            if status != 200:
                return False, 0
            data = json.loads(payload).get("data") or {}
            batching = data.get("batching") or {}
            return True, int(batching.get("slots", self.cfg.slots) or 0)
        # tdlint: disable=silent-swallow -- a refused connection is the expected answer while the replica boots
        except Exception:  # noqa: BLE001 — not up yet
            return False, 0

    # ------------------------------------------------- scale operations

    def _next_idx(self, parity: Optional[int] = None) -> int:
        """Smallest free replica idx; `parity` (0=prefill, 1=decode)
        restricts to one disaggregation pool's idx stride."""
        with self._cond:
            used = {r.idx for r in self.replicas.values()}
        i = parity or 0
        step = 1 if parity is None else 2
        while i in used:
            i += step
        return i

    def _scale_parity(self) -> Optional[int]:
        """Which pool the next scale-up should grow under the
        disaggregated policy: the smaller live pool (ties go to
        prefill). None under the shared policy."""
        if self.cfg.poolPolicy != "disaggregated":
            return None
        with self._cond:
            live = [r.idx for r in self.replicas.values()
                    if r.state in (READY, STARTING)]
        n_pre = sum(1 for i in live if i % 2 == 0)
        return 0 if n_pre <= len(live) - n_pre else 1

    def _donor(self) -> tuple[str, set]:
        """(warm donor container or "", chips hosting live replicas —
        the placement anti-affinity set)."""
        with self._cond:
            ready = sorted((r for r in self.replicas.values()
                            if r.state is READY),
                           key=lambda r: r.inflight)
            chips = {c for r in self.replicas.values()
                     if r.state in (READY, STARTING) for c in r.chips}
        return (ready[0].container if ready else ""), chips

    def scale_up(self, reason: str = "manual") -> dict:
        """Add one replica: re-admit a stopped one through the warm pool
        (its kept layer is already warm), else clone a ready donor's
        layer into a fresh replicaSet, else cold-start the first. The
        scale is journaled (`gateway.scale` + the replica's own run
        intent); the readiness probe opens the replica to claims."""
        trigger = time.monotonic()
        if self._wake_pending:
            trigger = min(trigger, self._wake_pending)
        with self._scale_mutex:
            # pool-aware growth: under disaggregation each scale-up
            # feeds the smaller pool, so the split stays balanced and
            # both phases keep capacity as the fleet grows/shrinks
            parity = self._scale_parity()
            with self._cond:
                stopped = sorted((r for r in self.replicas.values()
                                  if r.state in (STOPPED, FAILED)
                                  and (parity is None
                                       or r.idx % 2 == parity)),
                                 key=lambda r: r.idx)
            donor, avoid = self._donor()
            with trace.root_span(self.traces, "gateway.scale_up",
                                 target=self.cfg.name):
                if stopped:
                    out = self._readmit(stopped[0], reason)
                else:
                    out = self._spawn(self._next_idx(parity), donor,
                                      avoid, reason)
        with self._cond:
            self._wake_pending = 0.0
            self.scale_ups += 1
            # every scale op (manual included) pushes the cooldown
            # window: without this a manual scale_to raced the idle
            # scale-down decision tick-for-tick (observed live)
            self._last_scale = time.monotonic()
        self._record("gateway.scale_up", replica=out["replica"],
                     reason=reason, cloned=out.get("cloned", False),
                     warm=out.get("warm", False))
        self._changed()
        # stamp the trigger so the readiness probe prices request->ready
        with self._cond:
            r = self.replicas.get(out["replica"])
            if r is not None:
                r.started_at = trigger
        return out

    def _spawn(self, idx: int, donor: str, avoid: set,
               reason: str) -> dict:
        cfg = self.cfg
        rname = f"{cfg.name}r{idx}"
        intent = self._intents.begin("gateway.scale", cfg.name,
                                     kind=KIND_GATEWAY, direction="up",
                                     replica=rname, via=reason)
        try:
            req = ContainerRun(
                imageName=cfg.image, replicaSetName=rname,
                tpuCount=cfg.tpuCount, cpuCount=cfg.cpuCount,
                memory=cfg.memory, priority=cfg.priority,
                cmd=list(cfg.cmd),
                env=list(cfg.env) + [f"TDAPI_GATEWAY={cfg.name}",
                                     f"TDAPI_REPLICA={rname}"],
                containerPorts=[cfg.port])
            resp = self._svc.run_container(req, clone_from=donor,
                                           share_avoid=avoid or None,
                                           idem_partial=True)
            intent.step("replica_started", sync=False,
                        replica=rname, container=resp["name"])
        except Exception:
            intent.done()
            raise
        intent.done(committed=True)
        r = Replica(rname, idx)
        self._adopt_response(r, resp)
        with self._cond:
            self.replicas[rname] = r
        return {"replica": rname, "container": resp["name"],
                "cloned": bool(donor)}

    def _readmit(self, r: Replica, reason: str) -> dict:
        """Warm re-admission: restart the stopped/failed replica — a new
        version with fresh grants, its kept layer carried forward, the
        interpreter absorbed by the substrate's warm pool."""
        intent = self._intents.begin("gateway.scale", self.cfg.name,
                                     kind=KIND_GATEWAY, direction="up",
                                     replica=r.name, via=reason)
        try:
            resp = self._svc.restart_container(r.name)
            intent.step("replica_started", sync=False,
                        replica=r.name, container=resp["name"])
        except Exception:
            intent.done()
            raise
        intent.done(committed=True)
        with self._cond:
            self._adopt_response(r, resp)
            r.state = STARTING
            r.failures = 0
            r.started_at = time.monotonic()
            self.probation.drop(r.name)    # fresh start, fresh record
        return {"replica": r.name, "container": resp["name"], "warm": True}

    def _adopt_response(self, r: Replica, resp: dict) -> None:
        r.container = resp["name"]
        r.chips = list(resp.get("tpuChips") or [])
        ports = resp.get("portBindings") or {}
        r.host_port = int(ports.get(self.cfg.port, 0) or 0)
        r.state = STARTING
        r.started_at = time.monotonic()

    def scale_down(self, rname: str, reason: str = "manual") -> None:
        """Stop one replica: claims stop admitting into it immediately;
        the stop releases its grants and keeps its layer for warm
        re-admission. Journaled like scale-up."""
        with self._scale_mutex:
            self._scale_down_locked(rname, reason)

    def _scale_down_locked(self, rname: str, reason: str) -> None:
        with self._cond:
            r = self.replicas.get(rname)
            if r is None or r.state not in (READY, STARTING, FAILED):
                return
            r.state = STOPPING
        intent = self._intents.begin("gateway.scale", self.cfg.name,
                                     kind=KIND_GATEWAY, direction="down",
                                     replica=rname, via=reason)
        try:
            with trace.root_span(self.traces, "gateway.scale_down",
                                 target=self.cfg.name):
                self._svc.stop_container(rname)
            intent.step("replica_stopped", sync=False, replica=rname)
        except Exception:
            intent.done()
            with self._cond:
                r.state = FAILED      # unknown substrate state: not READY
            raise
        intent.done(committed=True)
        with self._cond:
            r.state = STOPPED
            r.inflight = 0
            self.scale_downs += 1
            self._last_scale = time.monotonic()
            self.probation.drop(rname)
        self._record("gateway.scale_down", replica=rname, reason=reason)
        self._changed()

    # ------------------------------------------------------------ status

    def describe(self) -> dict:
        with self._cond:
            reps = []
            for r in sorted(self.replicas.values(), key=lambda o: o.idx):
                d = r.describe()
                d["probation"] = (self._eject_on
                                  and self.probation.contains(r.name))
                reps.append(d)
            queued = self._queued
            tail = {
                "ejectEnabled": self._eject_on,
                "hedgeEnabled": self._hedge_on,
                "retryBudgetEnabled": self._retry_budget_on,
                "probation": self.probation.describe(),
                "ejections": self.ejections,
                "probationPasses": self.probation_passes,
                "hedges": self.hedges,
                "hedgeWins": self.hedge_wins,
                "retryBudgetExhausted": self.retry_budget_exhausted,
                "retryTokens": round(self.retry_budget.tokens, 3),
                "fleetMedianMs": (round(self._fleet_median_ms, 3)
                                  if self._fleet_median_ms is not None
                                  else None),
            }
        p99 = self.p99_ms()
        return {
            "tailTolerance": tail,
            "name": self.cfg.name,
            "config": self.cfg.to_json(),
            "replicas": reps,
            "readyReplicas": sum(1 for r in reps if r["state"] == READY),
            "queueDepth": queued,
            "inflight": sum(r["inflight"] for r in reps),
            "p99Ms": round(p99, 3) if p99 is not None else None,
            "requestsTotal": self.requests_total,
            "shedTotal": self.shed_total,
            "affinityHits": self.affinity_hits,
            "affinityTokens": self.affinity_tokens,
            "kvHandoffs": self.kv_handoffs,
            "scaleUps": self.scale_ups,
            "scaleDowns": self.scale_downs,
            "lastScaleReadyMs": (round(self.last_scale_ready_ms, 3)
                                 if self.last_scale_ready_ms is not None
                                 else None),
            "scaleReadyMsHistory": [round(x, 3) for x in self.ready_hist],
        }


class GatewayManager:
    """Create/delete/boot gateways; the App's handle on all of them."""

    def __init__(self, services, client, intents, events=None, traces=None,
                 transport: Optional[Callable] = None):
        self._svc = services
        self._client = client
        self._intents = intents
        self.events = events
        self.traces = traces
        self._transport = transport
        self._lock = threading.Lock()
        self._gateways: dict[str, Gateway] = {}
        # the worker tier's republish hook (set by App after the tier is
        # built); every gateway's on_change funnels through here
        self.on_change: Optional[Callable] = None

    def _roster_changed(self) -> None:
        cb = self.on_change
        if cb is not None:
            cb()

    def router_states(self) -> list[dict]:
        """Router state (config + replica roster) of every gateway — the
        payload the worker tier publishes into shared memory."""
        with self._lock:
            gws = list(self._gateways.values())
        return [g.router_state() for g in gws]

    # ------------------------------------------------------------ access

    def get(self, name: str) -> Gateway:
        with self._lock:
            gw = self._gateways.get(name)
        if gw is None:
            raise xerrors.NotExistInStoreError(f"gateway {name}")
        return gw

    def list(self) -> list[dict]:
        with self._lock:
            gws = list(self._gateways.values())
        return [g.describe() for g in gws]

    def snapshot(self) -> list[dict]:
        """Per-gateway counters for the /metrics collect callback."""
        return self.list()

    # ----------------------------------------------------------- create

    def create(self, cfg: GatewayConfig) -> dict:
        cfg.validate()
        # existence check + registration are ONE atomic step (the dict
        # insert IS the name reservation): check-then-act let two
        # concurrent creates of the same name both succeed, the second
        # silently overwriting the first's Gateway (whose autoscaler
        # thread would leak and fight over the same replica names
        # forever). The store write happens outside the lock — the
        # reservation already excludes racers — and unwinds on failure.
        gw = Gateway(cfg, self._svc, self._intents, events=self.events,
                     traces=self.traces, transport=self._transport,
                     on_change=self._roster_changed)
        with self._lock:
            if (cfg.name in self._gateways
                    or self._client.get(GATEWAYS, cfg.name) is not None):
                raise xerrors.GatewayExistedError(cfg.name)
            if replica_names_for(self._client, cfg.name):
                raise xerrors.GatewayExistedError(
                    f"{cfg.name}: replica-shaped replicaSets already "
                    f"exist")
            self._gateways[cfg.name] = gw
        try:
            # the record is the authority the boot path rebuilds from —
            # written synchronously BEFORE the first replica, so a crash
            # mid-create leaves a gateway that tops itself up to
            # minReplicas at boot
            self._client.put(GATEWAYS, cfg.name,
                             json.dumps(cfg.to_json()))
        except Exception:
            with self._lock:
                self._gateways.pop(cfg.name, None)
            raise
        try:
            for _ in range(cfg.minReplicas):
                gw.scale_up(reason="create")
        except Exception:
            # half-created: keep what exists (the autoscaler tops up /
            # the operator deletes); surface the failure
            gw.start()
            if self.events is not None:
                self.events.record("gateway.create", target=cfg.name,
                                   code=500, error="partial")
            raise
        gw.start()
        self._roster_changed()   # a zero-replica gateway must still be
        # routable by the worker tier (its queue bound + wake trigger)
        if self.events is not None:
            self.events.record("gateway.create", target=cfg.name,
                               minReplicas=cfg.minReplicas,
                               maxReplicas=cfg.maxReplicas)
        return gw.describe()

    # ------------------------------------------------------------ scale

    def scale_to(self, name: str, n: int) -> dict:
        """Manual scale to exactly n live replicas (bounded by the
        configured max; the autoscaler keeps managing afterwards)."""
        gw = self.get(name)
        n = max(0, min(int(n), gw.cfg.maxReplicas))
        for _ in range(16):               # bounded: no unbounded loop on races
            s = gw._signals()
            live = len(s["ready"]) + len(s["starting"])
            if live < n:
                gw.scale_up(reason="manual")
            elif live > n:
                victims = sorted(s["ready"] + s["starting"],
                                 key=lambda r: -r.idx)
                if not victims:
                    break
                gw.scale_down(victims[0].name, reason="manual")
            else:
                break
        return gw.describe()

    # ----------------------------------------------------------- delete

    def delete(self, name: str) -> None:
        gw = self.get(name)
        gw.stop()
        intent = self._intents.begin("gateway.delete", name,
                                     kind=KIND_GATEWAY)
        try:
            for rname in replica_names_for(self._client, name):
                try:
                    self._svc.delete_container(rname)
                except xerrors.XError:
                    log.warning("gateway %s: deleting replica %s failed",
                                name, rname)
            self._client.delete(GATEWAYS, name)
        except Exception:
            intent.done()
            raise
        intent.done(committed=True)
        with self._lock:
            self._gateways.pop(name, None)
        self._roster_changed()
        if self.events is not None:
            self.events.record("gateway.delete", target=name)

    # ------------------------------------------------------------- boot

    def boot(self) -> None:
        """Rebuild every gateway from its stored record and adopt its
        replicas from stored container records (adopt-by-name): running
        replicas re-enter as STARTING (the probe opens them), stopped
        ones as STOPPED (warm re-admission candidates). Runs after the
        reconciler, so half-done scale mutations are already settled."""
        for kv in self._client.range(GATEWAYS):
            self.boot_one(kv.key.rsplit("/", 1)[1])
        self._roster_changed()

    def boot_one(self, name: str) -> bool:
        """Rebuild ONE gateway from its stored record (the boot() body,
        per name — also the fleet takeover adoption path: a daemon that
        just stole this gateway's grant derives the roster from stored
        state, never from the dead owner). Idempotent: an already-live
        gateway is left running untouched."""
        with self._lock:
            if name in self._gateways:
                return False
        kv = self._client.get(GATEWAYS, name)
        if kv is None:
            return False
        try:
            cfg = GatewayConfig.from_json(json.loads(kv.value))
        except (ValueError, TypeError):
            log.exception("unreadable gateway record %s", name)
            return False
        gw = Gateway(cfg, self._svc, self._intents, events=self.events,
                     traces=self.traces, transport=self._transport,
                     on_change=self._roster_changed)
        pat = re.compile(re.escape(name) + _REPLICA_RE)
        for rname in replica_names_for(self._client, name):
            idx = int(pat.fullmatch(rname).group(1))
            r = Replica(rname, idx)
            try:
                info = self._svc.get_container_info(rname)
            except xerrors.XError:
                continue
            r.container = info["containerName"]
            spec = info.get("spec") or {}
            r.chips = list(spec.get("tpu_chips") or [])
            bindings = spec.get("port_bindings") or {}
            r.host_port = int(bindings.get(cfg.port, 0) or 0)
            if info.get("resourcesReleased"):
                r.state = STOPPED
            else:
                r.state = STARTING
                r.started_at = time.monotonic()
            gw.replicas[r.name] = r
        with self._lock:
            if name in self._gateways:   # lost a boot race — keep theirs
                gw.stop()
                return False
            self._gateways[name] = gw
        gw.start()
        return True

    def stop_all(self) -> None:
        with self._lock:
            gws = list(self._gateways.values())
        for g in gws:
            g.stop()
