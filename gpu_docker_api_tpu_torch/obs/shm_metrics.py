"""Shared-memory metric shards + flight-recorder rings for the worker tier.

The port's copy of the JAX control plane's obs/shm_metrics.py, over the
port's own build of the shm-atomics core (_native.py).

With `TDAPI_GW_WORKERS>0` every parse/admit/forward happens in a worker
process whose in-process registries nobody scrapes, so without shards
`tdapi_gateway_request_duration_ms` would not cover the traffic it
claims to describe. This module is the cross-process half of the
metrics registry: each worker owns one lock-free SHARD inside a
daemon-published `multiprocessing.shared_memory` segment — atomic
counters plus fixed-bucket histograms whose bucket layout MIRRORS the
in-process `obs/metrics.py` instruments — and the daemon's `/metrics`
collect callback sums the shards at scrape time (`Histogram.set_extern`
merges them into the same families the in-process path observes into).

Layout discipline (the same contract tdlint's shm rules enforce for
`server/workers.py`):

- counter/histogram words are touched ONLY through the native
  shm-atomics ops (`native/shm_atomics.cc`) — a raw buffer write into a
  counter word is a plain racy store that can wipe concurrent fetch_adds
  (`atomic-region`);
- the one non-atomic region — zeroing a gateway slot's cells when the
  roster slot changes identity — runs under a per-gateway SEQLOCK epoch
  word, so a scrape racing the reset (or a worker respawn racing a
  scrape) retries instead of summing half-zeroed shards; nothing that
  can block (I/O, spool writes, logging) runs inside that window
  (`seqlock-discipline`).

Each shard also carries a FLIGHT-RECORDER RING (obs/recorder.py): a
bounded circle of fixed-size entry slots the worker appends its recent
events/spans into. Because the ring lives in shared memory, the daemon's
watchdog can read a SIGKILLed worker's final segment — the postmortem
bundle surfaced as a `gateway.worker_postmortem` event — even though the
worker never got to flush anything.
"""

from __future__ import annotations

import ctypes
import json
import struct
import time
from multiprocessing import shared_memory
from typing import Optional

from .._native import load_nogil
from .metrics import GATEWAY_LATENCY, LATENCY_BUCKETS_MS

#: geometry twins of server/workers.py (asserted compatible there); the
#: segment is sized for the worker tier's maxima
SH_MAX_SHARDS = 8
SH_MAX_GATEWAYS = 16

SH_MAGIC = 0x7464_6170_696d_7831          # "tdapimx1"

#: per-request latency buckets — EXACTLY the in-process gateway
#: histogram's layout, so shard cells merge into that family losslessly
LAT_BUCKETS_MS: tuple = GATEWAY_LATENCY.buckets
#: admission queue-wait buckets (tdapi_gw_worker_queue_wait_ms)
QW_BUCKETS_MS: tuple = LATENCY_BUCKETS_MS

_NLAT = len(LAT_BUCKETS_MS) + 1           # + overflow cell
_NQW = len(QW_BUCKETS_MS) + 1

# ---- per-(shard, gateway) block, all 8-byte words -----------------------
# counters
C_REQUESTS = 0
C_SHED = 1
C_DEADLINE = 2
C_RETRIES = 3
_N_COUNTERS = 4
# latency histogram: _NLAT bucket cells + sum(us) + count
_LAT_WORDS = _NLAT + 2
# queue-wait histogram: _NQW bucket cells + sum(us) + count
_QW_WORDS = _NQW + 2
GW_BLOCK_WORDS = _N_COUNTERS + _LAT_WORDS + _QW_WORDS

# header: magic, version, then one seqlock epoch word per gateway slot
HDR_WORDS = 2 + SH_MAX_GATEWAYS

# flight-recorder ring, per shard: cursor word + RING_SLOTS fixed slots
# of [len word | payload]; entries are compact JSON, truncated to fit —
# a torn or truncated slot fails json parse and the reader skips it
# (documented best-effort: this is a crash recorder, not a ledger)
RING_SLOTS = 64
RING_PAYLOAD = 248
RING_SLOT_SZ = 8 + RING_PAYLOAD

_SHARD_CNT_SZ = SH_MAX_GATEWAYS * GW_BLOCK_WORDS * 8
_SHARD_RING_SZ = 8 + RING_SLOTS * RING_SLOT_SZ

SH_CNT_OFF = HDR_WORDS * 8
SH_RING_OFF = SH_CNT_OFF + SH_MAX_SHARDS * _SHARD_CNT_SZ
SEGMENT_SZ = SH_RING_OFF + SH_MAX_SHARDS * _SHARD_RING_SZ


def _sh_epoch_off(g: int) -> int:
    """Per-gateway seqlock epoch word (header region)."""
    return 16 + g * 8


def _sh_gw_off(s: int, g: int) -> int:
    """Base of shard `s`'s block for gateway slot `g` (counter region)."""
    return SH_CNT_OFF + (s * SH_MAX_GATEWAYS + g) * GW_BLOCK_WORDS * 8


def _sh_cnt_off(s: int, g: int, c: int) -> int:
    """One counter word (C_* index) in a shard's gateway block."""
    return _sh_gw_off(s, g) + c * 8


def _sh_lat_off(s: int, g: int) -> int:
    """First latency-bucket word of a shard's gateway block."""
    return _sh_gw_off(s, g) + _N_COUNTERS * 8


def _sh_qw_off(s: int, g: int) -> int:
    """First queue-wait-bucket word of a shard's gateway block."""
    return _sh_lat_off(s, g) + _LAT_WORDS * 8


def _sh_ring_off(s: int) -> int:
    """Shard `s`'s recorder-ring cursor word."""
    return SH_RING_OFF + s * _SHARD_RING_SZ


def _sh_ring_slot_off(s: int, i: int) -> int:
    return _sh_ring_off(s) + 8 + i * RING_SLOT_SZ


def _bucket_idx(buckets: tuple, v: float) -> int:
    idx = 0
    for bound in buckets:            # ~13 floats: scan beats bisect
        if v <= bound:
            break
        idx += 1
    return idx


class ShardGatewayView:
    """Hot-path handle for ONE (shard, gateway-slot) cell block with
    every address precomputed: the worker router holds one per gateway
    it serves, so a data-plane observation is a single PyDLL call with
    zero per-request offset arithmetic."""

    __slots__ = ("lib", "req_addr", "shed_addr", "dead_addr",
                 "retry_addr", "lat_addr", "qw_addr")

    def __init__(self, shards: "MetricShards", shard: int, g: int):
        self.lib = shards.lib
        base = shards.base
        self.req_addr = base + _sh_cnt_off(shard, g, C_REQUESTS)
        self.shed_addr = base + _sh_cnt_off(shard, g, C_SHED)
        self.dead_addr = base + _sh_cnt_off(shard, g, C_DEADLINE)
        self.retry_addr = base + _sh_cnt_off(shard, g, C_RETRIES)
        self.lat_addr = base + _sh_lat_off(shard, g)
        self.qw_addr = base + _sh_qw_off(shard, g)

    def inc_requests(self) -> None:
        self.lib.shm_add(self.req_addr, 1)

    def inc_shed(self) -> None:
        self.lib.shm_add(self.shed_addr, 1)

    def inc_deadline(self) -> None:
        self.lib.shm_add(self.dead_addr, 1)

    def inc_retries(self) -> None:
        self.lib.shm_add(self.retry_addr, 1)

    def observe_latency(self, ms: float) -> None:
        self.lib.shm_hist_observe(self.lat_addr,
                                  _bucket_idx(LAT_BUCKETS_MS, ms),
                                  _NLAT, int(ms * 1000))

    def observe_queue_wait(self, ms: float) -> None:
        self.lib.shm_hist_observe(self.qw_addr,
                                  _bucket_idx(QW_BUCKETS_MS, ms),
                                  _NQW, int(ms * 1000))

    def observe_queue_wait_zero(self) -> None:
        """Fast-path admission (no queuing): land in the first bucket
        without paying two clock reads for a sub-microsecond wait."""
        self.lib.shm_hist_observe(self.qw_addr, 0, _NQW, 0)


class MetricShards:
    """Owner (daemon, ``create=True``) / attacher (worker) of the shard
    segment. Worker-side methods are the hot path: each observe is a
    handful of native atomic fetch-adds. Daemon-side methods aggregate
    under the per-gateway seqlock and reset a slot when the roster
    reassigns it."""

    def __init__(self, name: Optional[str] = None, create: bool = False):
        # PyDLL handle: the shard ops are sub-us non-blocking atomics,
        # and a GIL release per call is both the dominant FFI cost and a
        # scheduler yield point on the serving hot path. NO blocking op
        # (futex et al.) may ever be called through this handle.
        self.lib = load_nogil("shmatomics")
        if self.lib is None:
            raise RuntimeError("shm-atomics core unavailable")
        if create:
            self.shm = shared_memory.SharedMemory(create=True,
                                                  size=SEGMENT_SZ)
            self.shm.buf[:SEGMENT_SZ] = b"\0" * SEGMENT_SZ
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.created = create
        self._anchor = ctypes.c_char.from_buffer(self.shm.buf)
        self.base = ctypes.addressof(self._anchor)
        if create:
            struct.pack_into("<qq", self.shm.buf, 0, SH_MAGIC, 1)

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

    # ---- worker side: observations ---------------------------------------

    def inc(self, shard: int, g: int, counter: int, n: int = 1) -> None:
        self.add(_sh_cnt_off(shard, g, counter), n)

    def observe_latency(self, shard: int, g: int, ms: float) -> None:
        # one FFI crossing: bucket += 1, sum_us += ms*1000, count += 1
        self.lib.shm_hist_observe(
            self.base + _sh_lat_off(shard, g),
            _bucket_idx(LAT_BUCKETS_MS, ms), _NLAT, int(ms * 1000))

    def observe_queue_wait(self, shard: int, g: int, ms: float) -> None:
        self.lib.shm_hist_observe(
            self.base + _sh_qw_off(shard, g),
            _bucket_idx(QW_BUCKETS_MS, ms), _NQW, int(ms * 1000))

    # ---- worker side: flight-recorder ring -------------------------------

    def ring_note(self, shard: int, entry: dict) -> None:
        """Append one entry to the shard's recorder ring. The payload is
        written BEFORE the slot's length word is armed, so a reader never
        sees a length describing bytes that aren't there yet; a writer
        killed mid-slot leaves len=0 (skipped) or a stale-but-whole
        previous entry — both fine for a flight recorder."""
        try:
            payload = json.dumps(entry, separators=(",", ":")).encode()
        except (TypeError, ValueError):
            return
        payload = payload[:RING_PAYLOAD]
        seq = self.add(_sh_ring_off(shard), 1) - 1
        off = _sh_ring_slot_off(shard, seq % RING_SLOTS)
        self.store(off, 0)                              # invalidate slot
        self.shm.buf[off + 8:off + 8 + len(payload)] = payload
        self.store(off, len(payload))

    def view(self, shard: int, g: int) -> ShardGatewayView:
        return ShardGatewayView(self, shard, g)

    def ring_writer(self, shard: int):
        """A bound sink callable for obs/recorder.FlightRecorder."""
        return lambda entry: self.ring_note(shard, entry)

    def read_ring(self, shard: int) -> list[dict]:
        """The shard's retained entries, oldest first — readable by the
        daemon even after the writer was SIGKILLed (the whole point)."""
        cursor = self.load(_sh_ring_off(shard))
        n = min(cursor, RING_SLOTS)
        out: list[dict] = []
        for k in range(n):
            i = (cursor - n + k) % RING_SLOTS
            off = _sh_ring_slot_off(shard, i)
            ln = self.load(off)
            if not 0 < ln <= RING_PAYLOAD:
                continue
            raw = bytes(self.shm.buf[off + 8:off + 8 + ln])
            try:
                out.append(json.loads(raw))
            except (ValueError, UnicodeDecodeError):
                continue                    # torn slot: skip, by contract
        return out

    # ---- daemon side: seqlock reset + aggregation ------------------------

    def reset_gateway(self, g: int) -> None:
        """Zero gateway slot `g`'s cells across every shard — the roster
        slot changed identity (gateway deleted / replaced), so the new
        tenant must not inherit the old one's distribution. Runs under
        the slot's seqlock epoch so a concurrent scrape retries instead
        of reading half-zeroed shards; the body is pure atomic stores
        (seqlock-discipline: nothing blocking inside the window)."""
        epoch = self.load(_sh_epoch_off(g))
        odd = epoch + 1 if epoch % 2 == 0 else epoch
        self.store(_sh_epoch_off(g), odd)
        try:
            for s in range(SH_MAX_SHARDS):
                base = _sh_gw_off(s, g)
                for w in range(GW_BLOCK_WORDS):
                    self.store(base + w * 8, 0)
        finally:
            self.store(_sh_epoch_off(g), odd + 1)

    def aggregate(self, g: int, n_shards: int = SH_MAX_SHARDS) -> dict:
        """Sum gateway slot `g` across shards, seqlock-consistently: the
        per-gateway epoch is read before and after the bulk read, so a
        reset (slot reassignment) mid-scrape retries rather than yielding
        a torn half-zeroed sum. Live increments are NOT serialized — a
        counter may move mid-read, which is ordinary scrape skew."""
        n_shards = min(n_shards, SH_MAX_SHARDS)
        words = GW_BLOCK_WORDS
        while True:
            e1 = self.load(_sh_epoch_off(g))
            if e1 & 1:
                time.sleep(0.0002)
                continue
            shards = []
            for s in range(n_shards):
                off = _sh_gw_off(s, g)
                shards.append(struct.unpack_from(
                    f"<{words}q", self.shm.buf, off))
            if self.load(_sh_epoch_off(g)) == e1:
                break
        per_worker = []
        lat = [0] * _NLAT
        lat_sum_us = lat_count = 0
        qw = [0] * _NQW
        qw_sum_us = qw_count = 0
        for vals in shards:
            per_worker.append({
                "requests": vals[C_REQUESTS], "shed": vals[C_SHED],
                "deadline": vals[C_DEADLINE], "retries": vals[C_RETRIES],
            })
            lo = _N_COUNTERS
            for i in range(_NLAT):
                lat[i] += vals[lo + i]
            lat_sum_us += vals[lo + _NLAT]
            lat_count += vals[lo + _NLAT + 1]
            qo = lo + _LAT_WORDS
            for i in range(_NQW):
                qw[i] += vals[qo + i]
            qw_sum_us += vals[qo + _NQW]
            qw_count += vals[qo + _NQW + 1]
        return {
            "perWorker": per_worker,
            "lat": {"buckets": lat, "sumMs": lat_sum_us / 1000.0,
                    "count": lat_count},
            "queueWait": {"buckets": qw, "sumMs": qw_sum_us / 1000.0,
                          "count": qw_count},
        }

    def close(self, unlink: bool = False) -> None:
        del self._anchor
        self.shm.close()
        if unlink and self.created:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass
