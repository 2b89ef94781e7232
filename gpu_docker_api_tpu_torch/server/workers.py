"""Multi-process SO_REUSEPORT data plane: escape the GIL on serving.

The port's copy of the JAX control plane's server/workers.py, over the
port's own build of the shm-atomics core (_native.py). It imports no
torch.

One interpreter parsing every request caps the serving tier at one core
(the stdlib HTTP parser holds the GIL), however many replicas sit behind
it. This module moves the DATA PLANE — parse, route-match,
admit, forward — into N worker processes that each bind the same port
with `SO_REUSEPORT` (the kernel load-balances accepted connections across
the listening sockets), while every control-plane mutation stays on the
single daemon.

The split that makes this possible is **router policy vs router state**:

- STATE lives in a `multiprocessing.shared_memory` segment: a seqlock-
  protected roster twin (gateway config + per-replica port/slots/ready,
  published by the daemon — `Gateway.router_state()`) plus lock-free
  atomic counters (per-replica inflight, per-gateway queue depth,
  request/shed totals) updated through the native shm-atomics core
  (native/shm_atomics.cc — CPython has no cross-process atomic RMW).
- POLICY (admit-on-slot-free, least-queued pick, strict-priority FIFO,
  queue-bound shed, per-request deadline) runs in `WorkerRouter`,
  identical in outcome to the in-process `Gateway` router: slot caps are
  enforced by atomic claim (`fetch_add` then undo on overshoot), the
  queue bound by a global atomic depth, priority barge by per-process
  hi/lo FIFOs, and "a slot freed somewhere" becomes a prompt cross-
  process wakeup via a futex on a per-gateway release-sequence word.

Crash safety: each worker also keeps per-(worker, gateway, replica)
CLAIM counters (incremented only after the global claim succeeds, so a
death between the two under-admits briefly instead of ever double-
admitting). The parent's watchdog detects a dead worker, subtracts its
claims from the global counters (reconcile), and respawns it; the dead
process's listening socket closed with it, so the kernel stops routing
new connections there immediately.

Requires Linux + the native shm-atomics core; `available()` gates the
tier and everything degrades to the in-process single-daemon data plane
when it is off (`TDAPI_GW_WORKERS` unset/0, or the core unbuilt).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import json
import logging
import os
import queue
import signal
import socket
import struct
import threading
import time

from collections import deque
from multiprocessing import get_context, shared_memory
from typing import Callable, Optional

from .. import faults, kvaffinity, tailtolerance
from .._native import load
from ..obs import shm_metrics
from ..obs import trace
from ..obs.recorder import FlightRecorder
from ..obs.spool import SpanSpool, SpoolTailer
from .codes import ResCode
from .http import (
    ApiServer, RawResponse, Request, Response, Router, StreamingResponse,
    err, ok, too_many,
)

log = logging.getLogger(__name__)

#: env knob: number of data-plane worker processes (0/unset = tier off)
GW_WORKERS_ENV = "TDAPI_GW_WORKERS"
#: env knob: explicit data-plane port (0 = pick a free one)
GW_DATA_PORT_ENV = "TDAPI_GW_DATA_PORT"

# ---- segment geometry (all fields 8-byte words unless noted) ----------------

MAX_GATEWAYS = 16
MAX_REPLICAS = 16
MAX_WORKERS = 8
NAME_LEN = 48

# the metric-shard segment (obs/shm_metrics.py) is addressed by the same
# (worker, gateway-slot) coordinates as this segment — the geometries
# must agree or shard writes land in another gateway's cells
assert shm_metrics.SH_MAX_SHARDS >= MAX_WORKERS
assert shm_metrics.SH_MAX_GATEWAYS == MAX_GATEWAYS

MAGIC = 0x7464_6170_6977_6b31          # "tdapiwk1"

# header words: magic, version, epoch(seqlock), n_gateways, n_workers,
# data_port, shutdown
HDR_WORDS = 8
HDR_OFF_EPOCH = 16
HDR_OFF_NGW = 24
HDR_OFF_SHUTDOWN = 48

# config region (seqlock-protected, plain bytes): per gateway
#   name[NAME_LEN] | maxQueue | deadline_ms | n_replicas |
#   per replica: port | slots | ready
GW_CONF_WORDS = 3
REP_CONF_WORDS = 3
GW_CONF_SZ = NAME_LEN + 8 * (GW_CONF_WORDS + MAX_REPLICAS * REP_CONF_WORDS)
CONF_OFF = HDR_WORDS * 8
CONF_SZ = MAX_GATEWAYS * GW_CONF_SZ

# counter region (atomics, NEVER seqlock-protected): per gateway
#   gen | queued | relseq | requests_total | shed_total | wake_hint |
#   affinity_hits_total | affinity_tokens_total |
#   hedges_total | hedge_wins_total | retry_budget_exhausted_total |
#   reserved |
#   per replica: inflight | errors | kv_gen | kv_occ | sketch[KV_SKETCH]
#                | lat_gen | lat_count | lat_ewma_us | lat_p95_us
# The kv cells (gen + occ + sketch words) form a mini-seqlock group
# (shm_cells_publish/read): workers fold each replica RESPONSE's
# advertised prefix sketch in, and the claim path reads it for affinity
# scoring — torn reads degrade to "no sketch", never retry. The lat
# cells are a second mini-seqlock group holding the replica's service-
# time digest (tailtolerance.LatencyDigest.to_cells): BOTH router tiers
# fold responses into it and BOTH run tailtolerance.eject_set over it,
# which is what makes their gray-failure ejection decisions identical
# with zero daemon round-trips.
KV_SKETCH_WORDS = 4                    # = kvaffinity.SKETCH_WORDS
LAT_CELL_WORDS = 3                     # count | ewma_us | p95_us
GW_CNT_WORDS = 12
REP_CNT_WORDS = 2 + 1 + 1 + KV_SKETCH_WORDS + 1 + LAT_CELL_WORDS
GW_CNT_SZ = 8 * (GW_CNT_WORDS + MAX_REPLICAS * REP_CNT_WORDS)
CNT_OFF = CONF_OFF + CONF_SZ
CNT_SZ = MAX_GATEWAYS * GW_CNT_SZ

# worker region: per worker
#   heartbeat_ns | pid | per gateway: queued_held | per (gw, rep): claims
WK_FIXED_WORDS = 2
WK_SZ = 8 * (WK_FIXED_WORDS + MAX_GATEWAYS * (1 + MAX_REPLICAS))
WK_OFF = CNT_OFF + CNT_SZ

SEGMENT_SZ = WK_OFF + MAX_WORKERS * WK_SZ


def _gw_conf_off(g: int) -> int:
    return CONF_OFF + g * GW_CONF_SZ


def _gw_cnt_off(g: int) -> int:
    return CNT_OFF + g * GW_CNT_SZ


def _rep_cnt_off(g: int, r: int) -> int:
    return _gw_cnt_off(g) + 8 * (GW_CNT_WORDS + r * REP_CNT_WORDS)


def _rep_kv_off(g: int, r: int) -> int:
    """Replica's kv cell group: gen word, then occ + sketch words."""
    return _rep_cnt_off(g, r) + 16


def _rep_lat_off(g: int, r: int) -> int:
    """Replica's latency-digest cell group: gen word, then the
    count | ewma_us | p95_us digest cells."""
    return _rep_cnt_off(g, r) + 8 * (2 + 1 + 1 + KV_SKETCH_WORDS)


def _wk_off(w: int) -> int:
    return WK_OFF + w * WK_SZ


def _wk_queued_off(w: int, g: int) -> int:
    return _wk_off(w) + 8 * WK_FIXED_WORDS + 8 * g


def _wk_claim_off(w: int, g: int, r: int) -> int:
    return (_wk_off(w) + 8 * WK_FIXED_WORDS + 8 * MAX_GATEWAYS
            + 8 * (g * MAX_REPLICAS + r))


#: test seam: tdcheck's interleaving explorer (tools/tdcheck) installs a
#: callable here to get schedulable yield points INSIDE the seqlock
#: publish window — between the odd-epoch store and the closing even
#: store — so torn-write interleavings are reachable under its
#: cooperative scheduler. Called with the gateway slot being written.
#: None (the default) costs one attribute load per publish slot.
_publish_yield: Optional[Callable[[int], None]] = None


def available() -> bool:
    """The worker tier needs Linux (SO_REUSEPORT + futex) and the native
    shm-atomics core."""
    return (hasattr(socket, "SO_REUSEPORT")
            and load("shmatomics") is not None)


class SharedRouterState:
    """Owner/attacher of the shared segment: seqlock roster publishing on
    the daemon side, consistent roster reads + atomic counter ops on the
    worker side. Both sides address the SAME bytes; the atomics go
    through native/shm_atomics.cc so cross-process RMW is real."""

    def __init__(self, name: Optional[str] = None, create: bool = False):
        self.lib = load("shmatomics")
        if self.lib is None:
            raise RuntimeError("shm-atomics core unavailable")
        if create:
            self.shm = shared_memory.SharedMemory(create=True,
                                                  size=SEGMENT_SZ)
            self.shm.buf[:SEGMENT_SZ] = b"\0" * SEGMENT_SZ
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.created = create
        # base address for the atomics: keep the from_buffer anchor alive
        # for the segment's lifetime (it pins the exported buffer)
        self._anchor = ctypes.c_char.from_buffer(self.shm.buf)
        self.base = ctypes.addressof(self._anchor)
        if create:
            struct.pack_into("<qq", self.shm.buf, 0, MAGIC, 1)

    @property
    def name(self) -> str:
        return self.shm.name

    # ---- raw atomic ops --------------------------------------------------

    def load(self, off: int) -> int:
        return self.lib.shm_load(self.base + off)

    def store(self, off: int, v: int) -> None:
        self.lib.shm_store(self.base + off, v)

    def add(self, off: int, d: int) -> int:
        return self.lib.shm_add(self.base + off, d)

    def dec_floor0(self, off: int) -> None:
        """CAS-decrement that never goes below zero: a release racing a
        publisher-side counter reset must not drive the counter negative
        (which would leak phantom capacity)."""
        lib, addr = self.lib, self.base + off
        while True:
            v = lib.shm_load(addr)
            if v <= 0:
                return
            if lib.shm_cas(addr, v, v - 1):
                return

    def futex_wait(self, off: int, expected: int, timeout_s: float) -> None:
        self.lib.shm_futex_wait(self.base + off,
                                expected & 0xFFFFFFFF,
                                max(0, int(timeout_s * 1000)))

    def futex_wake_all(self, off: int) -> None:
        self.lib.shm_futex_wake(self.base + off, 2 ** 30)

    # ---- daemon side: seqlock publish ------------------------------------

    def publish(self, states: list[dict]) -> list[int]:
        """Write the roster twin under the seqlock: epoch goes odd,
        config bytes land, epoch goes even — readers retry on any
        movement, so they only ever parse a consistent roster. Counter
        cells are NOT part of the protected region; a gateway keeps its
        slot (and counters) across publishes, and a slot reassigned to a
        different gateway bumps its generation word so stale releases
        skip themselves. Returns the slots whose IDENTITY changed this
        publish, so the caller can reset per-slot state that lives
        outside this segment (the metric shards) — outside the window,
        per seqlock discipline."""
        states = states[:MAX_GATEWAYS]
        buf = self.shm.buf
        # stable slot assignment: keep existing names in place
        current: dict[str, int] = {}
        for g in range(MAX_GATEWAYS):
            raw = bytes(buf[_gw_conf_off(g):_gw_conf_off(g) + NAME_LEN])
            n = raw.split(b"\0", 1)[0]
            if n:
                current[n.decode("utf-8", "replace")] = g
        assigned: dict[int, dict] = {}
        free = [g for g in range(MAX_GATEWAYS)
                if g not in current.values()]
        for st in states:
            slot = current.get(st["name"])
            if slot is None:
                if not free:
                    log.warning("worker tier: more than %d gateways; "
                                "%s stays daemon-routed", MAX_GATEWAYS,
                                st["name"])
                    continue
                slot = free.pop(0)
            assigned[slot] = st
        epoch = self.load(HDR_OFF_EPOCH)
        # A publisher killed inside the window parks the epoch odd. The
        # heal republish re-enters from that state, and `epoch + 1` would
        # flip it EVEN while the config bytes are mid-write (readers
        # parse a torn roster) then park it odd again at the close
        # (readers wedge until the next heal makes it worse, forever
        # alternating). Found by tdcheck's seqlock kill sweep: normalize
        # to odd-while-writing whatever parity the crash left behind.
        odd = epoch + 1 if epoch % 2 == 0 else epoch
        self.store(HDR_OFF_EPOCH, odd)                # odd: write in progress
        yield_seam = _publish_yield
        reassigned: list[int] = []
        try:
            for g in range(MAX_GATEWAYS):
                off = _gw_conf_off(g)
                st = assigned.get(g)
                if st is None:
                    buf[off:off + NAME_LEN] = b"\0" * NAME_LEN
                    continue
                if yield_seam is not None:
                    yield_seam(g)
                name = st["name"].encode()[:NAME_LEN - 1]
                raw = bytes(buf[off:off + NAME_LEN]).split(b"\0", 1)[0]
                if raw != name:
                    # slot changes identity: bump the gen word (in-flight
                    # releases see the mismatch and skip themselves) and
                    # ZERO the old tenant's counters + every worker's
                    # claim cells — without this the new gateway inherits
                    # phantom inflight that can never drain (its replicas
                    # would look permanently busy). A claim racing this
                    # re-checks gen after its fetch_add and undoes
                    # floor-clamped, so the transient is at most ±1 and
                    # self-corrects.
                    reassigned.append(g)
                    self.add(_gw_cnt_off(g), 1)       # gen word
                    self.store(_gw_cnt_off(g) + 8, 0)     # queued
                    self.store(_gw_cnt_off(g) + 24, 0)    # requests_total
                    self.store(_gw_cnt_off(g) + 32, 0)    # shed_total
                    self.store(_gw_cnt_off(g) + 40, 0)    # wake_hint
                    self.store(_gw_cnt_off(g) + 48, 0)    # affinity_hits
                    self.store(_gw_cnt_off(g) + 56, 0)    # affinity_tokens
                    self.store(_gw_cnt_off(g) + 64, 0)    # hedges
                    self.store(_gw_cnt_off(g) + 72, 0)    # hedge_wins
                    self.store(_gw_cnt_off(g) + 80, 0)    # budget_exhausted
                    self.store(_gw_cnt_off(g) + 88, 0)    # reserved
                    for r in range(MAX_REPLICAS):
                        # inflight, errors, AND the kv sketch group —
                        # the new tenant must not inherit the old one's
                        # prefix advertisement (mis-steered affinity)
                        self.store(_rep_cnt_off(g, r), 0)   # inflight
                        for word in range(1, REP_CNT_WORDS):
                            self.store(_rep_cnt_off(g, r) + 8 * word, 0)
                    for w in range(MAX_WORKERS):
                        self.store(_wk_queued_off(w, g), 0)
                        for r in range(MAX_REPLICAS):
                            self.store(_wk_claim_off(w, g, r), 0)
                buf[off:off + NAME_LEN] = name + b"\0" * (NAME_LEN
                                                          - len(name))
                reps = st["replicas"][:MAX_REPLICAS]
                struct.pack_into("<qqq", buf, off + NAME_LEN,
                                 int(st["maxQueue"]),
                                 int(st["deadlineMs"]), len(reps))
                roff = off + NAME_LEN + 8 * GW_CONF_WORDS
                for r in reps:
                    if yield_seam is not None:
                        yield_seam(g)
                    struct.pack_into("<qqq", buf, roff, int(r["port"]),
                                     int(r["slots"]),
                                     1 if r["ready"] else 0)
                    roff += 8 * REP_CONF_WORDS
        finally:
            self.store(HDR_OFF_EPOCH, odd + 1)        # even: consistent
        self.store(HDR_OFF_NGW, len(assigned))
        return reassigned

    # ---- worker side: consistent roster read -----------------------------

    def read_roster(self) -> tuple[int, dict]:
        """(epoch, {name: gateway-dict}) — seqlock retry until stable."""
        buf = self.shm.buf
        while True:
            e1 = self.load(HDR_OFF_EPOCH)
            if e1 & 1:
                time.sleep(0.0002)
                continue
            raw = bytes(buf[CONF_OFF:CONF_OFF + CONF_SZ])
            if self.load(HDR_OFF_EPOCH) == e1:
                break
        roster: dict[str, dict] = {}
        for g in range(MAX_GATEWAYS):
            off = g * GW_CONF_SZ
            name = raw[off:off + NAME_LEN].split(b"\0", 1)[0]
            if not name:
                continue
            max_queue, deadline_ms, n_reps = struct.unpack_from(
                "<qqq", raw, off + NAME_LEN)
            reps = []
            roff = off + NAME_LEN + 8 * GW_CONF_WORDS
            for r in range(min(n_reps, MAX_REPLICAS)):
                port, slots, ready = struct.unpack_from("<qqq", raw, roff)
                reps.append({"idx": r, "port": port, "slots": slots,
                             "ready": bool(ready)})
                roff += 8 * REP_CONF_WORDS
            roster[name.decode("utf-8", "replace")] = {
                "slot": g, "maxQueue": max_queue,
                "deadlineMs": deadline_ms, "replicas": reps,
                "gen": self.load(_gw_cnt_off(g)),
            }
        return e1, roster

    # ---- counters --------------------------------------------------------

    def gateway_counters(self, g: int) -> dict:
        return {"queued": self.load(_gw_cnt_off(g) + 8),
                "requestsTotal": self.load(_gw_cnt_off(g) + 24),
                "shedTotal": self.load(_gw_cnt_off(g) + 32),
                "wakeHint": self.load(_gw_cnt_off(g) + 40),
                "affinityHits": self.load(_gw_cnt_off(g) + 48),
                "affinityTokens": self.load(_gw_cnt_off(g) + 56),
                "hedges": self.load(_gw_cnt_off(g) + 64),
                "hedgeWins": self.load(_gw_cnt_off(g) + 72),
                "retryBudgetExhausted": self.load(_gw_cnt_off(g) + 80),
                "inflight": [self.load(_rep_cnt_off(g, r))
                             for r in range(MAX_REPLICAS)]}

    def publish_replica_kv(self, g: int, r: int, occ: int, words) -> None:
        """Advertise one replica's prefix sketch + KV occupancy through
        its mini-seqlock cell group. Concurrent writers (several workers
        seeing responses from the same replica) race benignly: a losing
        publish is dropped — the next response refreshes it."""
        from .. import kvaffinity
        vals = (ctypes.c_int64 * (1 + KV_SKETCH_WORDS))(
            int(occ), *(kvaffinity.signed64(w) for w in words))
        self.lib.shm_cells_publish(self.base + _rep_kv_off(g, r),
                                   self.base + _rep_kv_off(g, r) + 8,
                                   vals, 1 + KV_SKETCH_WORDS)

    def read_replica_kv(self, g: int, r: int):
        """(occupancy, sketch words) — None on a torn read or when the
        replica has advertised nothing yet. One attempt, no retry: the
        claim path treats None as 'no affinity signal' and the ordering
        degenerates to least-queued, which is always safe."""
        n = 1 + KV_SKETCH_WORDS
        out = (ctypes.c_int64 * n)()
        if self.lib.shm_cells_read(self.base + _rep_kv_off(g, r),
                                   self.base + _rep_kv_off(g, r) + 8,
                                   out, n):
            return None
        occ = out[0]
        words = [w & 0xFFFFFFFFFFFFFFFF for w in out[1:]]
        if occ <= 0 and not any(words):
            return None
        return occ, words

    def publish_replica_lat(self, g: int, r: int, cells) -> None:
        """Publish one replica's latency-digest cells
        (count | ewma_us | p95_us) through its mini-seqlock group.
        Racing folders lose benignly — a dropped sample is noise."""
        vals = (ctypes.c_int64 * LAT_CELL_WORDS)(*(int(c) for c in cells))
        self.lib.shm_cells_publish(self.base + _rep_lat_off(g, r),
                                   self.base + _rep_lat_off(g, r) + 8,
                                   vals, LAT_CELL_WORDS)

    def read_replica_lat(self, g: int, r: int):
        """(count, ewma_us, p95_us) or None on a torn read / no samples.
        One attempt, no retry: None degrades to 'no gray-failure signal
        for this replica', which can only under-eject — always safe."""
        out = (ctypes.c_int64 * LAT_CELL_WORDS)()
        if self.lib.shm_cells_read(self.base + _rep_lat_off(g, r),
                                   self.base + _rep_lat_off(g, r) + 8,
                                   out, LAT_CELL_WORDS):
            return None
        if out[0] <= 0:
            return None
        return out[0], out[1], out[2]

    def fold_replica_lat(self, g: int, r: int, ms: float) -> None:
        """Read-modify-publish one service-time sample into the digest
        cells (tailtolerance.fold_cells). Both tiers call this on every
        response, which is what keeps their ejection inputs identical."""
        from .. import tailtolerance
        self.publish_replica_lat(
            g, r, tailtolerance.fold_cells(self.read_replica_lat(g, r),
                                           ms))

    def reconcile_worker(self, w: int) -> int:
        """Subtract a dead worker's held claims + queue tickets from the
        global counters, zero its cells, and wake parked claimants (the
        freed slots are real capacity). Returns reclaimed claim count.
        Claims are incremented only AFTER the global fetch_add succeeded,
        so subtracting them can never free capacity that was not actually
        claimed — the zero-double-admit invariant."""
        reclaimed = 0
        for g in range(MAX_GATEWAYS):
            qoff = _wk_queued_off(w, g)
            q = self.load(qoff)
            if q > 0:
                for _ in range(q):
                    self.dec_floor0(_gw_cnt_off(g) + 8)
                self.store(qoff, 0)
            freed = 0
            for r in range(MAX_REPLICAS):
                coff = _wk_claim_off(w, g, r)
                c = self.load(coff)
                if c > 0:
                    freed += c
                    for _ in range(c):
                        self.dec_floor0(_rep_cnt_off(g, r))
                    self.store(coff, 0)
            reclaimed += freed
            if q > 0 or freed:
                self.add(_gw_cnt_off(g) + 16, 1)      # relseq
                self.futex_wake_all(_gw_cnt_off(g) + 16)
        return reclaimed

    def close(self, unlink: bool = False) -> None:
        # the ctypes anchor pins the exported buffer; drop it first
        del self._anchor
        self.shm.close()
        if unlink and self.created:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


class _LocalLine:
    """Per-process admission lines for one gateway slot: the strict-
    priority hi/lo FIFOs (identical to Gateway._claim's), guarded by a
    process-local lock. Cross-process wakeups ride the futex."""

    def __init__(self):
        self.lock = threading.Lock()
        self.hi: list = []
        self.lo: list = []


class _Claim:
    __slots__ = ("gslot", "rep", "gen", "port")

    def __init__(self, gslot: int, rep: int, gen: int, port: int):
        self.gslot = gslot
        self.rep = rep
        self.gen = gen
        self.port = port


class WorkerRouter:
    """The router POLICY over shared state: one instance per worker
    process (and per test harness — it is plain Python over a
    SharedRouterState, so the policy-parity suite drives it in-process).

    Outcomes match the in-process Gateway router: admit-on-slot-free via
    atomic claim against the replica's advertised slots, least-queued
    pick, strict-priority FIFO per process with hi barging lo, global
    queue bound -> 429, deadline -> 504, transport failure -> retry
    another replica until the deadline."""

    def __init__(self, state: SharedRouterState, worker_idx: int,
                 transport: Optional[Callable] = None,
                 shards=None, recorder=None):
        self.state = state
        self.widx = worker_idx
        self._transport = transport
        # cross-process telemetry (both optional — the policy-parity
        # suite and a telemetry-disarmed tier run without them):
        # `shards` is an obs/shm_metrics.MetricShards attachment this
        # worker observes its counters/histograms into; `recorder` is
        # the process flight recorder (obs/recorder.py)
        self.shards = shards
        self.recorder = recorder
        self._roster_epoch = -1
        self._roster: dict[str, dict] = {}
        self._roster_lock = threading.Lock()
        self._lines: dict[int, _LocalLine] = {}
        self._views: dict[int, object] = {}
        self._local = threading.local()
        # KV prefix-affinity routing: hash each prompt's chunk
        # prefixes and steer toward replicas whose advertised sketch says
        # the prefix is KV-resident. Purely an ordering refinement over
        # least-queued (kvaffinity.score) — turning it off restores the
        # exact prior pick, which is also what the paired bench compares.
        self._affinity = os.environ.get("TDAPI_GW_AFFINITY", "1") != "0"
        # tail tolerance: the same policy objects the in-process
        # Gateway runs, over the shm latency-digest cells — so both
        # tiers make identical gray-failure decisions from the same
        # state. The eject set is recomputed (not tracked): the worker
        # tier's probation is pure shm-derived, matching the daemon's
        # tracker because both call tailtolerance.eject_set over the
        # same cells.
        self._eject_on = tailtolerance.knob(tailtolerance.EJECT_ENV)
        self._hedge_on = tailtolerance.knob(tailtolerance.HEDGE_ENV)
        self._retry_on = tailtolerance.knob(
            tailtolerance.RETRY_BUDGET_ENV)
        self._eject_cache: dict[int, tuple] = {}
        self._eject_lock = threading.Lock()
        self._hedges: dict[int, tailtolerance.HedgePolicy] = {}
        self._budgets: dict[int, tailtolerance.RetryBudget] = {}

    def _hedge(self, g: int) -> tailtolerance.HedgePolicy:
        h = self._hedges.get(g)
        if h is None:
            h = self._hedges.setdefault(g, tailtolerance.HedgePolicy())
        return h

    def _budget(self, g: int) -> tailtolerance.RetryBudget:
        b = self._budgets.get(g)
        if b is None:
            b = self._budgets.setdefault(g, tailtolerance.RetryBudget())
        return b

    def _lat_snapshot(self, gw: dict) -> dict:
        """{row: (count, ewma_ms, p95_ms)} from the shm digest cells —
        the worker-side twin of LocalLatencyStore.snapshot()."""
        st = self.state
        g = gw["slot"]
        snap = {}
        for r in gw["replicas"]:
            cells = st.read_replica_lat(g, r["idx"])
            if cells is not None:
                snap[r["idx"]] = (cells[0], cells[1] / 1e3,
                                  cells[2] / 1e3)
        return snap

    def _ejected(self, gw: dict) -> frozenset:
        """Rows currently score-penalized as gray, minus the row whose
        deterministic trickle-probe window is open right now. Recomputed
        from the shm digests every WORKER_PROBE_WINDOW_S — the worker
        tier keeps no probation state, so its probation IS the
        recomputed eject set: the same pure tailtolerance.eject_set over
        the same shm-published cells the daemon gateway reads, hence
        identical ejection decisions in both tiers."""
        if not self._eject_on:
            return frozenset()
        g = gw["slot"]
        now = time.monotonic()
        with self._eject_lock:
            hit = self._eject_cache.get(g)
            if (hit is not None and hit[0] > now
                    and hit[2] == self._roster_epoch):
                ej = hit[1]
            else:
                ready = [r["idx"] for r in gw["replicas"]
                         if r["ready"] and r["port"]]
                snap = self._lat_snapshot(gw)
                stats = [(row, snap[row][2], snap[row][0])
                         for row in ready if row in snap]
                ej = frozenset(tailtolerance.eject_set(
                    stats, fleet=len(ready)))
                self._eject_cache[g] = (
                    now + tailtolerance.WORKER_PROBE_WINDOW_S, ej,
                    self._roster_epoch)
        if ej:
            probe = tailtolerance.trickle_allow(sorted(ej), now)
            if probe is not None:
                ej = ej - {probe}
        return ej

    def _view(self, g: int):
        """This worker's precomputed shard view for gateway slot `g`
        (obs/shm_metrics.ShardGatewayView) — one observation = one
        GIL-held PyDLL call; None when shards are off."""
        v = self._views.get(g)
        if v is None and self.shards is not None:
            v = self._views[g] = self.shards.view(self.widx, g)
        return v

    def _note(self, kind: str, **data) -> None:
        if self.recorder is not None:
            self.recorder.note(kind, **data)

    @staticmethod
    def _detailed_trace() -> bool:
        """Whether this request gets CHILD spans (admit/forward) or just
        root-level events. Client-traced requests (inbound traceparent —
        the root's parent is the caller's span) get the full chain; for
        the rest, per-request child spans measurably tax the data plane
        while the tail-sampling spool drops almost all of them — so the
        admit/forward facts ride the root span as events instead, which
        slow/error/sampled traces still carry."""
        cur = trace.current()
        return cur is not None and cur.parent_id is not None

    # ---- roster cache ----------------------------------------------------

    def _gateway(self, name: str) -> Optional[dict]:
        epoch = self.state.load(HDR_OFF_EPOCH)
        if epoch != self._roster_epoch:
            with self._roster_lock:
                if epoch != self._roster_epoch:
                    e, roster = self.state.read_roster()
                    self._roster = roster
                    self._roster_epoch = e
        return self._roster.get(name)

    def _line(self, gslot: int) -> _LocalLine:
        line = self._lines.get(gslot)
        if line is None:
            line = self._lines.setdefault(gslot, _LocalLine())
        return line

    # ---- claim / release -------------------------------------------------

    @staticmethod
    def _prefix_hashes(body: bytes) -> Optional[list]:
        """Chunk-prefix hashes of the request's prompt tokens, or None
        when the body has no hashable prefix (short prompt, non-JSON, no
        tokens). One parse per request, paid only with affinity on; a
        malformed body returns None here and fails later where the
        replica reports the real error."""
        try:
            tokens = json.loads(body).get("tokens")
        except (ValueError, AttributeError):
            return None
        if (isinstance(tokens, list) and tokens
                and isinstance(tokens[0], list)):
            tokens = tokens[0]                # nested [batch, len] shape
        if not isinstance(tokens, list):
            return None
        try:
            return kvaffinity.chunk_hashes(tokens) or None
        except (TypeError, ValueError):
            return None

    def _try_claim(self, gw: dict, avoid: frozenset = frozenset(),
                   hashes=None) -> Optional[_Claim]:
        """Affinity-scored atomic claim: order ready replicas by
        kvaffinity.score(sketch hit, global inflight) — with no prompt
        hashes or no advertised sketches the ordering degenerates to
        exactly least-queued — then fetch_add the best, undo on
        overshoot. Sketch reads come from this segment's per-replica kv
        cells ONLY (zero daemon round-trips on the route path; a torn
        read means hit=0, never a retry). The claim cell (this worker's
        ledger for crash reconcile) is incremented only after the global
        claim stuck. `avoid` holds replicas that already failed THIS
        request's forward — replica failure marking is control-plane
        state the daemon owns, so the worker only steers the current
        request away (identical outcome: a dead replica's error never
        fails the request while a healthy one exists)."""
        st = self.state
        g = gw["slot"]
        ejected = self._ejected(gw)
        ready = []
        for r in gw["replicas"]:
            if not r["ready"] or not r["port"] or r["idx"] in avoid:
                continue
            inflight = st.load(_rep_cnt_off(g, r["idx"]))
            hit = 0
            if hashes:
                kv = st.read_replica_kv(g, r["idx"])
                if kv is not None:
                    hit = kvaffinity.hit_tokens(kv[1], hashes)
            score = kvaffinity.score(hit, inflight)
            if r["idx"] in ejected:
                # gray-failure probation: composed ON TOP of the
                # affinity score, so an ejected replica serves only when
                # every healthy one is saturated (availability over
                # purity) — the same contract as Gateway._pick
                score += tailtolerance.PENALTY_SCORE
            ready.append((score, hit, r))
        ready.sort(key=lambda t: t[0])
        for _, hit, r in ready:
            off = _rep_cnt_off(g, r["idx"])
            if st.add(off, 1) <= r["slots"]:
                if st.load(_gw_cnt_off(g)) != gw["gen"]:
                    # the slot was reassigned mid-claim: undo against
                    # whatever lives there now (floor-clamped)
                    st.dec_floor0(off)
                    continue
                st.add(_wk_claim_off(self.widx, g, r["idx"]), 1)
                if hit > 0:
                    st.add(_gw_cnt_off(g) + 48, 1)    # affinity_hits
                    st.add(_gw_cnt_off(g) + 56, hit)  # affinity_tokens
                return _Claim(g, r["idx"], gw["gen"], r["port"])
            st.dec_floor0(off)
        return None

    def _release(self, c: _Claim) -> None:
        st = self.state
        if st.load(_gw_cnt_off(c.gslot)) == c.gen:
            st.dec_floor0(_wk_claim_off(self.widx, c.gslot, c.rep))
            st.dec_floor0(_rep_cnt_off(c.gslot, c.rep))
        relseq = _gw_cnt_off(c.gslot) + 16
        st.add(relseq, 1)
        st.futex_wake_all(relseq)

    def _claim(self, name: str, gw: dict, deadline: float, high: bool,
               avoid: frozenset = frozenset(), hashes=None) -> _Claim:
        """Block until a slot claim succeeds; shed on queue bound or
        deadline — Gateway._claim's contract over shared state. Every
        successful claim lands its queue wait in this worker's metric
        shard (the admission queue-wait histogram); sheds and deadline
        kills land in the shard counters — the telemetry a worker's death would lose."""
        from .. import xerrors  # local import: workers must stay light
        st = self.state
        g = gw["slot"]
        view = self._view(g)
        line = self._line(g)
        with line.lock:
            if not line.hi and (high or not line.lo):
                c = self._try_claim(gw, avoid, hashes)
                if c is not None:
                    if view is not None:
                        view.observe_queue_wait_zero()
                    return c
            qoff = _gw_cnt_off(g) + 8
            if st.load(qoff) >= gw["maxQueue"]:
                st.add(_gw_cnt_off(g) + 32, 1)        # shed_total
                if view is not None:
                    view.inc_shed()
                self._note("shed", gw=name, reason="queue_full")
                raise xerrors.GatewayShedError(
                    f"{name}: admission queue full ({gw['maxQueue']})")
            st.add(qoff, 1)
            st.add(_wk_queued_off(self.widx, g), 1)
            ticket = object()
            mine = line.hi if high else line.lo
            mine.append(ticket)
        t0 = time.monotonic()          # queue-wait clock: queuing began
        relseq = _gw_cnt_off(g) + 16
        try:
            while True:
                with line.lock:
                    at_head = mine and mine[0] is ticket and (
                        high or not line.hi)
                    if at_head:
                        c = self._try_claim(gw, avoid, hashes)
                        if c is not None:
                            if view is not None:
                                view.observe_queue_wait(
                                    (time.monotonic() - t0) * 1e3)
                            return c
                    seen = st.load(relseq)
                left = deadline - time.monotonic()
                if left <= 0:
                    st.add(_gw_cnt_off(g) + 32, 1)    # shed_total
                    if view is not None:
                        view.inc_deadline()
                    self._note("deadline", gw=name)
                    raise xerrors.GatewayDeadlineError(
                        f"{name}: no replica slot freed within the "
                        f"{gw['deadlineMs']:.0f}ms deadline")
                # cross-process park: any release bumps relseq and wakes
                # the futex; cap the wait so a roster change (new ready
                # replica) is noticed promptly too
                st.futex_wait(relseq, seen, min(left, 0.05))
                fresh = self._gateway(name)
                if fresh is not None:
                    gw = fresh
        finally:
            with line.lock:
                try:
                    mine.remove(ticket)
                except ValueError:
                    pass
            st.dec_floor0(qoff)
            st.dec_floor0(_wk_queued_off(self.widx, g))
            # line movement: peers re-check their head position
            st.add(relseq, 1)
            st.futex_wake_all(relseq)

    # ---- transport (pooled per thread+port, NODELAY) ---------------------

    @staticmethod
    def _replica_headers() -> dict:
        """Outbound headers for a replica call: the current span's W3C
        traceparent rides along, so the replica can echo it (and a future
        replica-side collector can join the trace)."""
        headers = {"Content-Type": "application/json"}
        cur = trace.current()
        if cur is not None:
            headers["traceparent"] = trace.format_traceparent(
                cur.trace_id, cur.span_id)
        return headers

    def _call(self, port: int, body: bytes, timeout: float):
        """One replica generate call. Returns (status, payload,
        queue_wait_ms, kv) — the replica advertises its batcher queue
        wait per response (X-TDAPI-Queue-Wait-Ms), which is how
        replica-side time stitches into the worker's trace, and its
        prefix-cache state (X-TDAPI-KV-Occ / X-TDAPI-KV-Sketch) which
        this worker folds into the shm kv cells; either is None when
        absent. Injected test transports return 2-tuples (both None),
        or up to 4-tuples with kv as an (occ, sketch_words) pair."""
        if self._transport is not None:
            out = self._transport(port, "POST", "/generate", body, timeout)
            status, payload = out[0], out[1]
            return (status, payload,
                    out[2] if len(out) > 2 else None,
                    out[3] if len(out) > 3 else None)
        import http.client
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
                         headers=self._replica_headers())
            resp = conn.getresponse()
            payload = resp.read()
            qw = resp.getheader("X-TDAPI-Queue-Wait-Ms")
            try:
                qw = float(qw) if qw is not None else None
            except ValueError:
                qw = None
            kv = None
            words = kvaffinity.decode_sketch_hex(
                resp.getheader("X-TDAPI-KV-Sketch") or "")
            if words is not None:
                try:
                    occ = int(resp.getheader("X-TDAPI-KV-Occ") or 0)
                except ValueError:
                    occ = 0
                kv = (occ, words)
            return resp.status, payload, qw, kv
        except Exception:
            pool.pop(port, None)
            if conn is not None:
                try:
                    conn.close()
                # tdlint: disable=silent-swallow -- closing an already-failed socket; the original error re-raises
                except Exception:  # noqa: BLE001
                    pass
            raise

    # ---- the forward path ------------------------------------------------

    def forward(self, name: str, body: bytes,
                priority: str = "") -> tuple[int, bytes]:
        from .. import xerrors
        gw = self._gateway(name)
        if gw is None:
            raise KeyError(name)
        st = self.state
        g = gw["slot"]
        view = self._view(g)
        st.add(_gw_cnt_off(g) + 24, 1)                # requests_total
        if view is not None:
            view.inc_requests()
        if not any(r["ready"] for r in gw["replicas"]):
            st.add(_gw_cnt_off(g) + 40, 1)            # wake hint
        t0 = time.monotonic()
        deadline = t0 + gw["deadlineMs"] / 1e3
        high = priority in ("high", "latency")
        detailed = self._detailed_trace()
        if detailed:
            # ring entries per REQUEST only for client-traced traffic —
            # errors/sheds/retries always note, and the claim ledger
            # (postmortem claimDelta) names any in-flight work, so the
            # always-on cost stays off the untraced hot path
            self._note("req", gw=name)
        hashes = self._prefix_hashes(body) if self._affinity else None
        hedge_delay = None
        if self._hedge_on:
            hedge_delay = self._hedge(g).delay_s(
                lambda: self._lat_snapshot(gw))
        avoid: set = set()
        while True:
            if detailed:
                with trace.span("gateway.admit", target=name):
                    c = self._claim(name, gw, deadline, high=high,
                                    avoid=frozenset(avoid),
                                    hashes=hashes)
            else:
                c = self._claim(name, gw, deadline, high=high,
                                avoid=frozenset(avoid), hashes=hashes)
            left = deadline - time.monotonic()
            exc = None
            if hedge_delay is not None and self._hedge(g).peek():
                out = self._forward_hedged(name, gw, c, body, deadline,
                                           t0, hedge_delay, view)
                if isinstance(out, BaseException):
                    exc = out        # attempts released + counted errors
                else:
                    self._budget(g).success()
                    self._hedge(g).feed()
                    return out
            else:
                t_send = time.monotonic()
                try:
                    with (trace.span("gateway.forward", target=name,
                                     replica=c.rep, port=c.port)
                          if detailed
                          else contextlib.nullcontext(
                              trace.current())) as fsp:
                        status, payload, qwait, kv = self._call(
                            c.port, body, timeout=max(left, 0.05))
                        if fsp is not None and qwait is not None:
                            # replica-side batcher queue wait, advertised
                            # on the response: the replica's contribution
                            # to this span's time, stitched without a
                            # replica-side collector (root-level event
                            # when the request is not client-traced)
                            fsp.event("replica.queue_wait", ms=qwait)
                # tdlint: disable=silent-swallow -- not swallowed: exc feeds the retry path below, which notes/raises it
                except Exception as e:  # noqa: BLE001 — replica gone/slow
                    self._release(c)
                    st.add(_rep_cnt_off(c.gslot, c.rep) + 8, 1)  # errors
                    exc = e
            if exc is not None:
                if view is not None:
                    view.inc_retries()
                self._note("retry", gw=name, replica=c.rep,
                           error=type(exc).__name__)
                if time.monotonic() >= deadline:
                    if view is not None:
                        view.inc_deadline()
                    raise xerrors.GatewayDeadlineError(
                        f"{name}: replicas unreachable "
                        f"({type(exc).__name__})")
                # retry budget, not retry-until-deadline: a brownout
                # that exhausts the bucket sheds 503 + Retry-After
                # instead of multiplying its own load
                if (self._retry_on
                        and not self._budget(g).try_retry()):
                    st.add(_gw_cnt_off(g) + 80, 1)
                    self._note("budget_shed", gw=name)
                    raise xerrors.GatewayRetryBudgetError(
                        f"{name}: retry budget exhausted "
                        f"({type(exc).__name__})")
                avoid.add(c.rep)
                fresh = self._gateway(name)
                if fresh is not None:
                    gw = fresh
                if len(avoid) >= sum(1 for r in gw["replicas"]
                                     if r["ready"] and r["port"]):
                    avoid.clear()    # every replica failed once: retry all
                continue
            svc_ms = (time.monotonic() - t_send) * 1e3
            self._release(c)
            if st.load(_gw_cnt_off(c.gslot)) == c.gen:
                # fold the replica's advertised prefix sketch + this
                # response's service time into its shm cells so EVERY
                # worker's (and the daemon's) next decision sees them —
                # these are the only write paths; the route path never
                # asks the daemon (or the replica) anything
                st.fold_replica_lat(c.gslot, c.rep, svc_ms)
                if kv is not None:
                    st.publish_replica_kv(c.gslot, c.rep, kv[0], kv[1])
            self._budget(g).success()
            self._hedge(g).feed()
            if view is not None:
                view.observe_latency((time.monotonic() - t0) * 1e3)
            return status, payload

    def _forward_hedged(self, name: str, gw: dict, c: _Claim,
                        body: bytes, deadline: float, t0: float,
                        hedge_delay: float, view):
        """Worker-tier hedge race — Gateway._forward_hedged's shape over
        shm claims. The primary runs on its own thread; if it outlives
        the digest-derived delay and the token bucket allows, ONE
        duplicate is claimed (never onto the primary) and dispatched.
        First completion wins; the loser cannot be cancelled mid-flight,
        so each attempt thread releases its own claim on completion.
        The hedge claim is BaseException-safe around the hedge.in_flight
        crashpoint (the crash sweep pins no leaked claims). Returns
        (status, payload), or the last exception when every attempt
        failed — the caller owns the retry/shed decision."""
        st = self.state
        results: queue.Queue = queue.Queue()

        def attempt(cl: _Claim, is_hedge: bool) -> None:
            t_send = time.monotonic()
            try:
                status, payload, _qwait, kv = self._call(
                    cl.port, body,
                    timeout=max(deadline - time.monotonic(), 0.05))
            except BaseException as e:  # noqa: BLE001 — the claim must release whatever the transport threw
                self._release(cl)
                st.add(_rep_cnt_off(cl.gslot, cl.rep) + 8, 1)  # errors
                results.put((is_hedge, None, None, e))
                if not isinstance(e, Exception):
                    raise            # injected crashes stay fatal here
                return
            svc_ms = (time.monotonic() - t_send) * 1e3
            self._release(cl)
            if st.load(_gw_cnt_off(cl.gslot)) == cl.gen:
                st.fold_replica_lat(cl.gslot, cl.rep, svc_ms)
                if kv is not None:
                    st.publish_replica_kv(cl.gslot, cl.rep,
                                          kv[0], kv[1])
            results.put((is_hedge, status, payload, None))

        threading.Thread(target=attempt, args=(c, False),
                         name=f"wk{self.widx}-fwd", daemon=True).start()
        in_flight = 1
        first = None
        try:
            first = results.get(timeout=hedge_delay)
        except queue.Empty:
            pass
        hedge = self._hedge(c.gslot)
        if first is None and hedge.take():
            # never hedge onto the primary; ejected rows are score-
            # penalized inside _try_claim, so a gray replica is the
            # hedge target only when nothing else has capacity
            hc = self._try_claim(gw, avoid=frozenset({c.rep}))
            if hc is None:
                hedge.put_back()     # nobody to hedge onto
            else:
                try:
                    faults.crashpoint("hedge.in_flight")
                except BaseException:
                    self._release(hc)
                    raise
                st.add(_gw_cnt_off(c.gslot) + 64, 1)      # hedges
                self._note("hedge", gw=name, primary=c.rep,
                           replica=hc.rep)
                threading.Thread(target=attempt, args=(hc, True),
                                 name=f"wk{self.widx}-hedge",
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
                    st.add(_gw_cnt_off(c.gslot) + 72, 1)  # hedge_wins
                if view is not None:
                    view.observe_latency((time.monotonic() - t0) * 1e3)
                return status, payload
            if taken >= in_flight:
                return exc           # every attempt failed

    # ---- HTTP handlers (the worker's route table) ------------------------

    def _forward_stream(self, name: str, body: bytes, priority: str):
        """?stream=1: claim a slot, issue the replica request on a FRESH
        connection (a half-relayed pooled socket could never be reused),
        and return a chunk iterator that releases the claim on exit."""
        from .. import xerrors
        import http.client
        gw = self._gateway(name)
        if gw is None:
            raise KeyError(name)
        st = self.state
        g = gw["slot"]
        view = self._view(g)
        st.add(_gw_cnt_off(g) + 24, 1)                # requests_total
        if view is not None:
            view.inc_requests()
        t0 = time.monotonic()
        deadline = t0 + gw["deadlineMs"] / 1e3
        high = priority in ("high", "latency")
        detailed = self._detailed_trace()
        if detailed:
            self._note("req", gw=name, stream=True)
        hashes = self._prefix_hashes(body) if self._affinity else None
        avoid: set = set()
        while True:
            if detailed:
                with trace.span("gateway.admit", target=name):
                    c = self._claim(name, gw, deadline, high=high,
                                    avoid=frozenset(avoid),
                                    hashes=hashes)
            else:
                c = self._claim(name, gw, deadline, high=high,
                                avoid=frozenset(avoid), hashes=hashes)
            left = max(deadline - time.monotonic(), 0.05)
            conn = http.client.HTTPConnection("127.0.0.1", c.port,
                                              timeout=left)
            try:
                conn.request("POST", "/generate", body=body,
                             headers=self._replica_headers())
                resp = conn.getresponse()
            except Exception as e:  # noqa: BLE001 — replica gone/slow
                conn.close()
                self._release(c)
                st.add(_rep_cnt_off(c.gslot, c.rep) + 8, 1)
                if view is not None:
                    view.inc_retries()
                if time.monotonic() >= deadline:
                    if view is not None:
                        view.inc_deadline()
                    raise xerrors.GatewayDeadlineError(
                        f"{name}: replicas unreachable "
                        f"({type(e).__name__})")
                if (self._retry_on
                        and not self._budget(c.gslot).try_retry()):
                    st.add(_gw_cnt_off(c.gslot) + 80, 1)
                    raise xerrors.GatewayRetryBudgetError(
                        f"{name}: retry budget exhausted "
                        f"({type(e).__name__})")
                avoid.add(c.rep)
                fresh = self._gateway(name)
                if fresh is not None:
                    gw = fresh          # a replacement replica may exist
                if len(avoid) >= sum(1 for r in gw["replicas"]
                                     if r["ready"] and r["port"]):
                    avoid.clear()
                continue

            def relay(c=c, conn=conn, resp=resp, view=view, t0=t0):
                try:
                    while True:
                        chunk = resp.read(8192)
                        if not chunk:
                            return
                        yield chunk
                finally:
                    conn.close()
                    self._release(c)
                    if view is not None:
                        # latency spans the whole relay, like the
                        # in-process _relay's observe
                        view.observe_latency(
                            (time.monotonic() - t0) * 1e3)

            return relay()

    def h_generate(self, req: Request) -> Response:
        from .. import xerrors
        name = req.params["name"]
        priority = req.header("X-TDAPI-Priority").strip().lower()
        try:
            if req.query_flag("stream"):
                chunks = self._forward_stream(name, req.body,
                                              priority=priority)
                return StreamingResponse(chunks,
                                         content_type="application/json")
            _status, payload = self.forward(name, req.body,
                                            priority=priority)
            return RawResponse(payload)
        except KeyError:
            return err(ResCode.GatewayGetInfoFailed)
        except xerrors.GatewayShedError:
            return too_many("gateway queue full")
        except xerrors.GatewayDeadlineError as e:
            return Response(ResCode.GatewayTimeout, None, msg=str(e),
                            http_status=504, headers={"Retry-After": "1"})
        except xerrors.GatewayRetryBudgetError as e:
            # budget exhaustion sheds instead of amplifying: 503 with a
            # Retry-After the client can honor, never unbounded retries
            return Response(ResCode.BackendUnavailable, None, msg=str(e),
                            http_status=503,
                            headers={"Retry-After": str(e.retry_after)})
        except Exception:  # noqa: BLE001 — the envelope absorbs it
            log.exception("worker %d: generate %s failed", self.widx, name)
            return err(ResCode.GatewayRequestFailed)

    def h_healthz(self, req: Request) -> Response:
        _, roster = self.state.read_roster()
        return ok({"worker": self.widx, "pid": os.getpid(),
                   "gateways": sorted(roster)})


# ---- the worker process -----------------------------------------------------

def _worker_main(host: str, port: int, shm_name: str, worker_idx: int,
                 api_key: str = "", metrics_name: str = "",
                 spool_dir: str = "", telemetry: bool = True) -> None:
    """Child entry (spawn context): bind the data-plane port with
    SO_REUSEPORT, serve generate end-to-end, heartbeat into the segment,
    drain gracefully on SIGTERM. Telemetry wiring: the metric-shard
    segment attaches by name, finished spans spool to this process's
    spans-<pid>.jsonl (the daemon tails and merges them), and the flight
    recorder mirrors into the shard's shm ring so a SIGKILL still leaves
    a readable final segment."""
    if not telemetry:
        trace.set_enabled(False)
    state = SharedRouterState(name=shm_name)
    shards = None
    if telemetry and metrics_name:
        try:
            shards = shm_metrics.MetricShards(name=metrics_name)
        except Exception:  # noqa: BLE001 — serve without shards rather than not at all
            log.exception("worker %d: metric shards unavailable",
                          worker_idx)
    recorder = FlightRecorder(
        sink=shards.ring_writer(worker_idx) if shards is not None
        else None)
    recorder.note("boot", worker=worker_idx, pid=os.getpid())
    spool = None
    if telemetry and spool_dir:
        try:
            os.makedirs(spool_dir, exist_ok=True)
            spool = SpanSpool(os.path.join(
                spool_dir, f"spans-{os.getpid()}.jsonl"),
                recorder=recorder)
        except OSError:
            log.exception("worker %d: span spool unavailable", worker_idx)
    wr = WorkerRouter(state, worker_idx, shards=shards, recorder=recorder)
    router = Router()
    router.add("POST", "/api/v1/gateways/:name/generate", wr.h_generate)
    router.add("GET", "/api/v1/healthz", wr.h_healthz)
    router.add("GET", "/ping",
               lambda req: ok({"status": "pong", "worker": worker_idx}))
    srv = ApiServer(router, addr=f"{host}:{port}", api_key=api_key,
                    reuse_port=True, traces=spool,
                    quiet_routes=frozenset(
                        {("POST", "/api/v1/gateways/:name/generate")}))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    srv.start()
    state.store(_wk_off(worker_idx) + 8, os.getpid())
    parent = os.getppid()
    try:
        while not stop.wait(0.05):
            state.store(_wk_off(worker_idx), time.monotonic_ns())
            if state.load(HDR_OFF_SHUTDOWN):
                break
            if os.getppid() != parent:
                # the daemon died without cleanup (SIGKILL skips atexit):
                # an orphaned worker would keep serving a STALE roster on
                # the old data port forever — exit instead; the restarted
                # daemon brings its own tier on a fresh segment
                log.warning("worker %d: daemon gone — exiting",
                            worker_idx)
                break
    finally:
        try:
            srv.stop(drain_timeout=5.0)     # in-flight requests complete
        # tdlint: disable=silent-swallow -- last-gasp drain; the process exits either way
        except Exception:  # noqa: BLE001
            pass
        # graceful exit: drain the spool tail and flush the recorder to
        # its postmortem file (the SIGTERM/atexit half of the recorder
        # contract; SIGKILL relies on the shm ring instead)
        recorder.note("exit", worker=worker_idx)
        try:
            if spool is not None:
                spool.close()
            if spool_dir:
                recorder.flush_to(os.path.join(
                    spool_dir, f"recorder-{os.getpid()}.json"))
        # tdlint: disable=silent-swallow -- last-gasp telemetry flush; the process exits either way
        except Exception:  # noqa: BLE001
            pass
    os._exit(0)


class ShmLatencyStore:
    """Daemon-side latency store backed by the shm digest cells — the
    drop-in twin of tailtolerance.LocalLatencyStore that WorkerTier
    swaps into each live Gateway while the tier runs. The in-process
    router then folds its responses into — and runs its ejection tick
    over — the SAME cells every worker process uses, which is the
    tier-parity contract: one signal, two readers, identical
    decisions."""

    def __init__(self, state: SharedRouterState, gateway: str):
        self._state = state
        self._gateway = gateway
        self._slot: Optional[int] = None
        self._n = 0
        self._epoch = -1

    def _resolve(self) -> Optional[int]:
        """The gateway's current roster slot, re-read only when the
        roster epoch moved (slot assignments are sticky)."""
        epoch = self._state.load(HDR_OFF_EPOCH)
        if epoch != self._epoch:
            _, roster = self._state.read_roster()
            ent = roster.get(self._gateway)
            self._slot = ent["slot"] if ent is not None else None
            self._n = len(ent["replicas"]) if ent is not None else 0
            self._epoch = epoch
        return self._slot

    def fold(self, row: int, ms: float) -> None:
        g = self._resolve()
        if g is not None and 0 <= row < MAX_REPLICAS:
            self._state.fold_replica_lat(g, row, ms)

    def snapshot(self) -> dict:
        g = self._resolve()
        out: dict = {}
        if g is None:
            return out
        for row in range(min(self._n, MAX_REPLICAS)):
            cells = self._state.read_replica_lat(g, row)
            if cells is not None:
                out[row] = (cells[0], cells[1] / 1e3, cells[2] / 1e3)
        return out

    def reset(self, row: int) -> None:
        g = self._resolve()
        if g is not None and 0 <= row < MAX_REPLICAS:
            self._state.publish_replica_lat(g, row, (0, 0, 0))


class WorkerTier:
    """Parent-side lifecycle: owns the segment, publishes the roster,
    spawns/respawns workers, reconciles a dead worker's counters, drains
    on stop."""

    #: watchdog cadence; also bounds publish latency after a poke
    TICK_S = 0.05
    #: periodic republish even without pokes (heals missed transitions)
    REPUBLISH_S = 0.25
    #: a worker whose heartbeat is older than this is declared hung
    HEARTBEAT_STALE_S = 10.0

    #: postmortem bundles retained for /healthz (newest last)
    MAX_POSTMORTEMS = 8
    #: recorder entries surfaced per postmortem bundle
    POSTMORTEM_TAIL = 16

    def __init__(self, gateways, n: int, host: str = "127.0.0.1",
                 port: int = 0, events=None, api_key: str = "",
                 traces=None, spool_dir: Optional[str] = None,
                 telemetry: bool = True):
        if not available():
            raise RuntimeError("worker tier unavailable "
                               "(needs Linux + native shm-atomics core)")
        self.gateways = gateways
        self.n = max(1, min(int(n), MAX_WORKERS))
        self.host = host
        self.port = int(port)
        self.events = events
        self.api_key = api_key
        # cross-process telemetry plane (obs/): the daemon-side handles.
        # `traces` is the daemon's TraceCollector (worker span spools
        # merge into it); `spool_dir` hosts spans-<pid>.jsonl +
        # recorder-<pid>.json; telemetry=False runs the tier dark (the
        # bench's obs_mp A/B arm)
        self.traces = traces
        self.spool_dir = spool_dir
        self.telemetry = bool(telemetry)
        self.metric_shards = None
        self._tailer: Optional[SpoolTailer] = None
        self._agg_cache: Optional[dict] = None
        self._agg_at = 0.0
        self.postmortems: deque = deque(maxlen=self.MAX_POSTMORTEMS)
        self.state: Optional[SharedRouterState] = None
        self.procs: list = [None] * self.n
        self.respawns = 0
        self.reclaimed_claims = 0
        self._poke = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ctx = get_context("spawn")

    # ---- lifecycle -------------------------------------------------------

    def _alloc_port(self) -> int:
        """Reserve a concrete port number for the SO_REUSEPORT group (a
        port-0 bind per worker would scatter them across N ports)."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((self.host, self.port))
            return s.getsockname()[1]
        finally:
            s.close()

    def start(self) -> None:
        self.state = SharedRouterState(create=True)
        if self.telemetry:
            try:
                self.metric_shards = shm_metrics.MetricShards(create=True)
            except Exception:  # noqa: BLE001 — the tier must serve even with shards unavailable
                log.exception("worker tier: metric shards unavailable")
            if self.spool_dir and self.traces is not None:
                try:
                    os.makedirs(self.spool_dir, exist_ok=True)
                    # stale spool files from a PREVIOUS daemon run were
                    # already merged into that daemon's collector (and
                    # live on in its traces.jsonl) — re-tailing them
                    # would duplicate old traces into the fresh ring and
                    # grow the directory without bound across restarts
                    self._prune_spool()
                    self._tailer = SpoolTailer(self.spool_dir, self.traces)
                except OSError:
                    log.exception("worker tier: span spool dir "
                                  "unavailable")
        self.state.publish(self.gateways.router_states())
        self.port = self._alloc_port()
        struct.pack_into("<q", self.state.shm.buf, 40, self.port)
        for i in range(self.n):
            self._spawn(i)
        # the manager's change hook funnels here: publish on next tick
        self.gateways.on_change = self.poke
        self._thread = threading.Thread(target=self._watchdog,
                                        name="gw-workers", daemon=True)
        self._thread.start()
        log.info("worker tier: %d SO_REUSEPORT workers on %s:%d",
                 self.n, self.host, self.port)

    def _spawn(self, idx: int) -> None:
        p = self._ctx.Process(
            target=_worker_main,
            args=(self.host, self.port, self.state.name, idx,
                  self.api_key,
                  (self.metric_shards.name
                   if self.metric_shards is not None else ""),
                  self.spool_dir or "", self.telemetry),
            name=f"gw-worker-{idx}", daemon=True)
        p.start()
        self.procs[idx] = p

    def poke(self) -> None:
        self._poke.set()

    def _prune_spool(self, pid: Optional[int] = None) -> None:
        """Remove spool artifacts: ONE dead worker's files (after the
        reap's final merge — a long-lived tier must not accumulate a
        file per crashed pid, each globbed and stat()ed every tailer
        poll forever) or ALL of them (tier boot, see start())."""
        if not self.spool_dir:
            return
        if pid is not None:
            pats = [f"spans-{pid}.jsonl", f"spans-{pid}.jsonl.1",
                    f"recorder-{pid}.json"]
        else:
            pats = ["spans-*.jsonl", "spans-*.jsonl.1",
                    "recorder-*.json"]
        for pat in pats:
            for path in glob.glob(os.path.join(self.spool_dir, pat)):
                try:
                    os.unlink(path)
                except OSError:
                    continue
                if self._tailer is not None:
                    self._tailer.forget(path)

    # ---- watchdog --------------------------------------------------------

    def _watchdog(self) -> None:
        last_pub = 0.0
        last_wake: dict[int, int] = {}
        while not self._stop.wait(self.TICK_S):
            try:
                now = time.monotonic()
                if (self._poke.is_set()
                        or now - last_pub >= self.REPUBLISH_S):
                    self._poke.clear()
                    states = self.gateways.router_states()
                    reassigned = self.state.publish(states)
                    self._bind_lat_stores(st["name"] for st in states)
                    # a reassigned roster slot must not hand its metric
                    # history to the new tenant gateway; the reset runs
                    # HERE, outside the roster's publish window, under
                    # the shard segment's own per-slot seqlock
                    if self.metric_shards is not None:
                        for g in reassigned:
                            self.metric_shards.reset_gateway(g)
                    last_pub = now
                self._check_workers()
                self._relay_wake_hints(last_wake)
                if self._tailer is not None:
                    self._tailer.poll()     # merge worker span spools
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("worker-tier watchdog tick")

    def _bind_lat_stores(self, names) -> None:
        """Swap each live Gateway's latency store for the shm-backed
        twin (ShmLatencyStore) so both router tiers fold into — and
        eject from — the same digest cells. Idempotent per gateway;
        stop() swaps the local store back before the segment unmaps."""
        for name in names:
            try:
                gw = self.gateways.get(name)
            # tdlint: disable=silent-swallow -- the gateway was deleted between roster build and bind
            except Exception:  # noqa: BLE001
                continue
            # fakes/minimal gateways without a latency store (policy-
            # parity tests) just don't participate in digest publishing
            store = getattr(gw, "lat_store", None)
            if store is not None and not isinstance(store,
                                                    ShmLatencyStore):
                gw.lat_store = ShmLatencyStore(self.state, name)

    def _unbind_lat_stores(self) -> None:
        """Teardown half of _bind_lat_stores: every gateway falls back
        to a fresh local store BEFORE the segment unmaps, so a fold
        racing stop() lands in a live object, never a closed buffer."""
        try:
            states = self.gateways.router_states()
        # tdlint: disable=silent-swallow -- manager already torn down; nothing left to unbind
        except Exception:  # noqa: BLE001
            return
        for st in states:
            try:
                gw = self.gateways.get(st["name"])
            # tdlint: disable=silent-swallow -- deleted mid-teardown
            except Exception:  # noqa: BLE001
                continue
            if isinstance(getattr(gw, "lat_store", None),
                          ShmLatencyStore):
                gw.lat_store = tailtolerance.LocalLatencyStore()

    def _check_workers(self) -> None:
        for i, p in enumerate(self.procs):
            if p is None or p.is_alive():
                hb = self.state.load(_wk_off(i))
                if (p is not None and hb
                        and time.monotonic_ns() - hb
                        > self.HEARTBEAT_STALE_S * 1e9):
                    log.warning("worker %d heartbeat stale — killing", i)
                    p.kill()
                    p.join(timeout=1)
                else:
                    continue
            # dead: snapshot the worker's held claims (the cells are
            # stable — their writer is gone) for the postmortem's claim-
            # reconcile delta, reconcile its shared-memory footprint,
            # then respawn — the kernel already stopped routing to its
            # closed socket
            delta = self._claim_delta(i)
            reclaimed = self.state.reconcile_worker(i)
            self.reclaimed_claims += reclaimed
            if not self._stop.is_set():
                self.respawns += 1
                self._capture_postmortem(i, p, reclaimed, delta)
                # final merge of the dead worker's spooled spans, then
                # drop its files — the respawn writes under a new pid
                if self._tailer is not None:
                    try:
                        self._tailer.poll()
                    except Exception:  # noqa: BLE001 — the reap must finish
                        log.exception("worker %d: final spool merge", i)
                pid = getattr(p, "pid", None)
                if pid:
                    self._prune_spool(pid)
                if self.events is not None:
                    self.events.record("gateway.worker_respawn",
                                       target=f"worker-{i}", code=500,
                                       reclaimed=reclaimed)
                self.state.store(_wk_off(i), 0)
                self._spawn(i)

    def _claim_delta(self, w: int) -> dict:
        """Per-gateway claims/queue tickets a dead worker still held —
        exactly what reconcile_worker is about to subtract (read first:
        reconcile zeroes the cells)."""
        out: dict[str, dict] = {}
        _, roster = self.state.read_roster()
        slot_names = {ent["slot"]: name for name, ent in roster.items()}
        for g in range(MAX_GATEWAYS):
            q = self.state.load(_wk_queued_off(w, g))
            claims = sum(self.state.load(_wk_claim_off(w, g, r))
                         for r in range(MAX_REPLICAS))
            if q or claims:
                out[slot_names.get(g, f"slot-{g}")] = {
                    "claims": claims, "queued": q}
        return out

    def _capture_postmortem(self, i: int, p, reclaimed: int,
                            delta: dict) -> None:
        """The flight-recorder half of reaping a dead worker: read its
        shm recorder ring (readable even after SIGKILL — no handler ran
        in the worker), bundle it with the claim-reconcile delta, retain
        the bundle for the /healthz workers block, and surface a
        `gateway.worker_postmortem` event."""
        entries: list = []
        if self.metric_shards is not None:
            try:
                entries = self.metric_shards.read_ring(i)
            except Exception:  # noqa: BLE001 — a torn ring must not block the respawn
                log.exception("worker %d: postmortem ring read", i)
        tail = entries[-self.POSTMORTEM_TAIL:]
        pm = {
            "worker": i,
            "pid": getattr(p, "pid", None),
            "at": round(time.time(), 3),
            "reclaimedClaims": reclaimed,
            "claimDelta": delta,
            "recorder": tail,
        }
        self.postmortems.append(pm)
        if self.events is not None:
            self.events.record(
                "gateway.worker_postmortem", target=f"worker-{i}",
                code=500, pid=pm["pid"], reclaimed=reclaimed,
                claimDelta=delta,
                recorderEntries=len(entries),
                lastOps=[e.get("k", "?") for e in tail[-5:]])

    def _relay_wake_hints(self, last_wake: dict[int, int]) -> None:
        """Workers can't run the autoscaler; they bump a wake-hint
        counter when requests arrive with zero live replicas. Relay it to
        the owning Gateway's wake trigger (scale-to-zero wake)."""
        _, roster = self.state.read_roster()
        for name, ent in roster.items():
            slot = ent["slot"]
            hint = self.state.load(_gw_cnt_off(slot) + 40)
            if hint > last_wake.get(slot, 0):
                last_wake[slot] = hint
                try:
                    self.gateways.get(name).note_external_demand()
                # tdlint: disable=silent-swallow -- the gateway was deleted between roster read and relay
                except Exception:  # noqa: BLE001
                    pass

    # ---- observability ---------------------------------------------------

    def describe(self) -> dict:
        out = {"count": self.n, "port": self.port,
               "alive": sum(1 for p in self.procs
                            if p is not None and p.is_alive()),
               "respawns": self.respawns,
               "reclaimedClaims": self.reclaimed_claims,
               "telemetry": self.telemetry
               and self.metric_shards is not None,
               "postmortems": list(self.postmortems),
               "gateways": {}}
        if self.state is not None:
            _, roster = self.state.read_roster()
            for name, ent in roster.items():
                c = self.state.gateway_counters(ent["slot"])
                out["gateways"][name] = {
                    "requestsTotal": c["requestsTotal"],
                    "shedTotal": c["shedTotal"],
                    "queued": c["queued"],
                    "inflight": sum(c["inflight"]),
                    "affinityHits": c["affinityHits"],
                    "affinityTokens": c["affinityTokens"],
                    "hedges": c["hedges"],
                    "hedgeWins": c["hedgeWins"],
                    "retryBudgetExhausted": c["retryBudgetExhausted"],
                }
        return out

    # ---- scrape-time aggregation (server/app.py collect callback) --------

    #: one shard sweep serves every consumer of the SAME scrape: the
    #: collect callback (per-worker counters), the merged latency
    #: histogram's extern, and the queue-wait extern all render within
    #: milliseconds of each other — re-sweeping per consumer tripled
    #: the seqlock reads and word unpacks for identical data
    AGG_CACHE_S = 0.2

    def _shard_aggregates(self) -> dict:
        """{gateway name: shm_metrics aggregate} for every live roster
        slot — one seqlock-consistent read per gateway per SCRAPE (the
        three scrape-time consumers share a short-lived snapshot, which
        also keeps counters and histograms from the same sweep)."""
        if self.metric_shards is None or self.state is None:
            return {}
        now = time.monotonic()
        cached = self._agg_cache
        if cached is not None and now - self._agg_at < self.AGG_CACHE_S:
            return cached
        _, roster = self.state.read_roster()
        out = {}
        for name, ent in roster.items():
            out[name] = self.metric_shards.aggregate(ent["slot"],
                                                     n_shards=self.n)
        # racing scrapes may each compute once; both snapshots are
        # valid, last writer wins — no lock needed
        self._agg_cache, self._agg_at = out, now
        return out

    def latency_extern(self) -> dict:
        """Worker-served request latencies, shaped for
        Histogram.set_extern on tdapi_gateway_request_duration_ms — this
        is what makes that family truthful under TDAPI_GW_WORKERS>0."""
        out = {}
        for name, agg in self._shard_aggregates().items():
            lat = agg["lat"]
            if lat["count"]:
                out[(name,)] = (lat["buckets"], lat["sumMs"],
                                lat["count"])
        return out

    def queue_wait_extern(self) -> dict:
        """Admission queue-wait distribution per gateway
        (tdapi_gw_worker_queue_wait_ms)."""
        out = {}
        for name, agg in self._shard_aggregates().items():
            qw = agg["queueWait"]
            if qw["count"]:
                out[(name,)] = (qw["buckets"], qw["sumMs"], qw["count"])
        return out

    def per_worker_counts(self) -> dict:
        """{gateway: [per-worker {requests, shed, deadline, retries}]}
        for the tdapi_gw_worker_* counter families."""
        return {name: agg["perWorker"][:self.n]
                for name, agg in self._shard_aggregates().items()}

    # ---- stop ------------------------------------------------------------

    def stop(self, drain_timeout: float = 8.0) -> None:
        self._stop.set()
        if self.gateways.on_change == self.poke:
            self.gateways.on_change = None
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._unbind_lat_stores()
        if self.state is not None:
            self.state.store(HDR_OFF_SHUTDOWN, 1)
        for p in self.procs:
            if p is not None and p.is_alive():
                p.terminate()               # SIGTERM: graceful drain
        deadline = time.monotonic() + drain_timeout
        for p in self.procs:
            if p is not None:
                p.join(timeout=max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=2)
        if self._tailer is not None:
            try:
                self._tailer.poll()     # the drained workers' final spans
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("worker tier: final spool merge")
            self._tailer = None
        if self.metric_shards is not None:
            self.metric_shards.close(unlink=True)
            self.metric_shards = None
        if self.state is not None:
            self.state.close(unlink=True)
            self.state = None
