"""Substrate health monitor: chip presence, reachability, flap detection.

The scheduler's view of the mesh is optimistic — a chip is "free" until
granted — but real TPU fleets lose chips (PCIe drops, driver resets, host
faults) and treat that as routine reschedulable capacity loss (PAPERS.md:
arxiv 2109.11067 reconfigurable-machine scheduling; 2008.09213
heterogeneity-aware pools). This monitor is the detection half; the
scheduler's cordon set + the drain operation are the response half.

Three probes per cycle, all through Backend health hooks (base.py):

- **chip presence** — `backend.chip_available(device_path)`: device-node
  existence on process/docker substrates, injectable on MockBackend;
- **substrate reachability** — `backend.ping()`: dockerd /_ping on the
  docker substrate, in-process truth elsewhere;
- **container flap** — `backend.flap_counts()`: the process supervisor's
  restart counters (process.py _supervise_one); a container crash-looping
  on a chip is evidence against the CHIP, not just the workload.

Failures accumulate per-chip scores (consecutive probe failures; flapping
adds to every chip the container holds). A score crossing fail_threshold
auto-cordons the chip (opt-out) — granted chips keep running until a drain
migrates them. A recovered chip's score resets, but cordons are only ever
lifted explicitly (uncordon): flapping hardware that comes back for one
probe must not oscillate in and out of the allocatable pool.

The monitor deliberately probes the UNGUARDED backend (GuardedBackend
unwraps via .inner at App wiring): health probing must keep observing the
substrate precisely when the breaker is refusing workload traffic.

The port's copy of the JAX control plane's health.py, unchanged: `tpu` is
the card scheduler (GpuScheduler), and the chips it probes are the cards'
device nodes (/dev/nvidia<minor>).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class HealthMonitor:
    def __init__(self, backend, tpu, events=None,
                 interval: float = 5.0,
                 fail_threshold: int = 3,
                 flap_threshold: int = 3,
                 auto_cordon: bool = True):
        self.backend = backend
        self.tpu = tpu
        self.events = events
        self.interval = interval
        self.fail_threshold = max(1, int(fail_threshold))
        self.flap_threshold = max(1, int(flap_threshold))
        self.auto_cordon = auto_cordon
        self._lock = threading.Lock()
        self._scores: dict[int, int] = {}       # chip index -> consecutive fails
        self._substrate_ok = True
        self._flapping: dict[str, int] = {}     # container -> flap count
        self._probes = 0
        self._last_probe_at = 0.0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ probing

    def probe_once(self) -> dict:
        """One full probe cycle; returns the fresh report. Safe to call
        concurrently with the background loop (scores are lock-guarded)."""
        # probe failure IS the signal here, not an error to surface:
        # an exploding ping means unreachable
        try:
            substrate_ok = bool(self.backend.ping())
        except Exception:  # noqa: BLE001  # tdlint: disable=silent-swallow -- failure is the probe result
            substrate_ok = False

        # flap evidence first, so it lands in the same cycle's scores
        try:
            flaps = {n: c for n, c in self.backend.flap_counts().items()
                     if c >= self.flap_threshold}
        except Exception:  # noqa: BLE001  # tdlint: disable=silent-swallow -- failure is the probe result
            flaps = {}
        flap_chips: set[int] = set()
        for name in flaps:
            try:
                state = self.backend.inspect(name)
                if state.spec is not None:
                    flap_chips.update(state.spec.tpu_chips)
            except Exception:  # noqa: BLE001  # tdlint: disable=silent-swallow -- container may be mid-removal
                continue

        # ALL backend probing happens before taking the monitor lock: a
        # hung device node must stall only this prober, never park
        # report() (served at /healthz) behind a dead substrate — and
        # lockwatch flags any lock held across a backend op. The topology
        # object is immutable after construction, so walking its chips
        # without a lock is safe.
        presence: dict[int, bool] = {}
        for chip in self.tpu.topology.chips:
            try:
                presence[chip.index] = bool(
                    self.backend.chip_available(chip.device_path))
            except Exception:  # noqa: BLE001  # tdlint: disable=silent-swallow -- failure is the probe result
                presence[chip.index] = False
        already_cordoned = self.tpu.cordoned_snapshot()

        to_cordon: list[int] = []
        with self._lock:
            self._probes += 1
            self._last_probe_at = time.time()
            self._substrate_ok = substrate_ok
            self._flapping = flaps
            for chip in self.tpu.topology.chips:
                failed = (not presence.get(chip.index, False)
                          or chip.index in flap_chips)
                if failed:
                    self._scores[chip.index] = \
                        self._scores.get(chip.index, 0) + 1
                else:
                    self._scores[chip.index] = 0
                if (self.auto_cordon
                        and self._scores[chip.index] >= self.fail_threshold
                        and chip.index not in already_cordoned):
                    to_cordon.append(chip.index)

        if to_cordon:
            self.tpu.cordon(to_cordon)
            log.warning("health: auto-cordoned chips %s "
                        "(score >= %d)", to_cordon, self.fail_threshold)
            if self.events is not None:
                try:
                    self.events.record("health.cordon", code=200,
                                       chips=to_cordon,
                                       threshold=self.fail_threshold)
                except Exception:  # noqa: BLE001
                    log.exception("recording health.cordon event")
        return self.report()

    def report(self) -> dict:
        """Last-known component report (served at GET /api/v1/healthz)."""
        with self._lock:
            scores = dict(self._scores)
            substrate_ok = self._substrate_ok
            flapping = dict(self._flapping)
            probes = self._probes
            last_at = self._last_probe_at
        cordoned_set = self.tpu.cordoned_snapshot()
        cordoned = sorted(cordoned_set)
        chips = [{
            "index": c.index,
            "device": c.device_path,
            "failureScore": scores.get(c.index, 0),
            "healthy": scores.get(c.index, 0) == 0,
            "cordoned": c.index in cordoned_set,
        } for c in self.tpu.topology.chips]
        degraded = (not substrate_ok or bool(cordoned) or bool(flapping)
                    or any(s > 0 for s in scores.values()))
        return {
            "status": "degraded" if degraded else "ok",
            "substrate": {"reachable": substrate_ok},
            "chips": chips,
            "cordoned": cordoned,
            "flapping": flapping,
            "probes": probes,
            "lastProbeAt": round(last_at, 3),
            "running": self._thread is not None,
        }

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None or self.interval <= 0:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.probe_once()
                except Exception:  # noqa: BLE001 — the prober must outlive
                    log.exception("health probe cycle failed")

        self._thread = threading.Thread(target=loop, name="health-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
