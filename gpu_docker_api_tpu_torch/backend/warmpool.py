"""Warm worker pool: pre-imported Python interpreters for fast workload start.

The port's copy of the JAX control plane's backend/warmpool.py, for torch
workloads. The cold path of a Python workload pays interpreter startup and
`import torch` (about 2 s on a CPU host) before any device work begins. The
card grant is pure environment: CUDA_VISIBLE_DEVICES and CUDA_DEVICE_ORDER
are read at `cuInit`, the first CUDA call, not at `import torch`. So a
worker that has imported torch, but has not initialised CUDA, can take any
granted card set: it sets the job's env first and CUDA reads it later.

Mechanics: the pool keeps N idle workers, each a `python -c <worker loop>`
child that imports the configured modules and then blocks on stdin. Starting
a container hands ONE json job line to a worker: {cmd, env, cwd, log}. The
worker redirects stdout/stderr onto the container log, replaces its
environment wholesale with the container's (daemon env + spec env + card
grant — exactly what a cold spawn would see), chdirs, rebinds sys.argv, and
runs the command in-process (exec for `-c`, runpy for scripts/modules). The
worker *becomes* the container process: the parent keeps its Popen, so
stop/pause/inspect (killpg etc.) are identical to the cold path.

The card guard: a worker whose preimports initialised CUDA has fixed its
device set already, and would run the job on the wrong cards. It never
does: when the job arrives it checks torch's flag and asks the driver
whether cuInit has run (a bare driver call such as
`torch.cuda.is_available()` initialises the driver without setting
torch's flag). Either one makes it `exec` the job's command instead — a
cold spawn in the same process, so the parent's Popen and process group
stay valid. Workers see every card of the node: a probe under an empty
CUDA_VISIBLE_DEVICES would fail its cuInit, leave the driver
uninitialised and the guard blind, and torch would keep its count of no
card for the job.

Only python commands are absorbed (`python [-u] -c/-m/script ...`); anything
else — and any dispatch failure — falls back to the cold spawn in
ProcessBackend.start, as do jobs that set env a warm interpreter cannot
honour (PYTHON*, IMPORT_BAKED_ENV). The workers' own environment (`env`,
e.g. a PYTHONPATH) reaches their import path, which a job's env cannot. A
taken worker is replaced asynchronously, so its replacement warms its
imports while the dispatched workload runs.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

# The worker loop. Runs under `python -u -c`; heavy imports happen BEFORE
# the stdin read, so an idle worker is a fully warmed interpreter.
_WORKER_SRC = r"""
import importlib, json, os, sys
for _m in os.environ.get("TDAPI_WARM_PREIMPORT", "").split(","):
    _m = _m.strip()
    if _m:
        try:
            importlib.import_module(_m)
        except Exception:
            pass
_line = sys.stdin.buffer.readline()
if not _line.strip():
    sys.exit(0)                      # pool shutdown: EOF on stdin
_job = json.loads(_line)
_fd = os.open(_job["log"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
os.dup2(_fd, 1)
os.dup2(_fd, 2)
os.close(_fd)
os.environ.clear()
os.environ.update(_job["env"])
os.chdir(_job["cwd"])
# the card guard: once the driver is initialised (cuInit) it has read its
# device set, before this job's CUDA_VISIBLE_DEVICES existed here, so the
# job must not run in this interpreter. torch's own flag misses a bare
# driver call (torch.cuda.is_available() runs cuInit without setting it),
# and torch maps the driver library at import without initialising it, so
# the guard asks the driver: until cuInit it answers every call with
# CUDA_ERROR_NOT_INITIALIZED (3). exec the command instead: a cold spawn
# in this process.
def _driver_initialised():
    try:
        with open("/proc/self/maps") as f:
            libs = [l.split()[-1] for l in f if "/libcuda.so" in l]
    except OSError:
        return True                  # cannot tell: start the job cold
    if not libs:
        return False
    import ctypes
    try:
        n = ctypes.c_int(0)
        return ctypes.CDLL(libs[0]).cuDeviceGetCount(ctypes.byref(n)) != 3
    except (OSError, AttributeError):
        return True
if (("torch" in sys.modules and sys.modules["torch"].cuda.is_initialized())
        or _driver_initialised()):
    print("warm worker: CUDA was initialised before the job; starting it "
          "cold", flush=True)
    os.execvpe(_job["cmd"][0], _job["cmd"], _job["env"])
_args = _job["cmd"][1:]
while _args and _args[0] == "-u":
    _args = _args[1:]
import runpy
if _args[0] == "-c":
    sys.argv = ["-c"] + _args[2:]
    _g = {"__name__": "__main__", "__builtins__": __builtins__}
    exec(compile(_args[1], "<warm-worker>", "exec"), _g)
elif _args[0] == "-m":
    sys.argv = _args[1:]
    runpy.run_module(_args[1], run_name="__main__", alter_sys=True)
else:
    sys.argv = _args
    runpy.run_path(_args[0], run_name="__main__")
"""


class WarmPool:
    """N idle pre-imported interpreters; take() pops one, a replacement
    spawns in the background."""

    def __init__(self, size: int = 1, preimport: str = "torch",
                 give_up_after: int = 5, backoff_base: float = 0.05,
                 backoff_cap: float = 2.0, env: Optional[dict] = None):
        self.size = max(int(size), 0)
        self.preimport = preimport
        # the workers' own environment on top of the daemon's (a PYTHONPATH
        # reaches their import path here; a job's env cannot)
        self.env = dict(env or {})
        # refill damping: a worker that can't spawn (or dies before it is
        # ever taken — e.g. a preimport that crashes the interpreter) must
        # not turn the take->refill cycle into a hot respawn loop. Each
        # consecutive failure backs the next refill off exponentially, and
        # give_up_after consecutive failures disables the pool entirely
        # (every start falls back to the cold path — correct, just slower).
        self.give_up_after = max(1, int(give_up_after))
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._consec_failures = 0
        self._gave_up = False
        self._lock = threading.Lock()
        self._idle: list[subprocess.Popen] = []
        self._closed = False
        for _ in range(self.size):
            self._add_worker()

    # ---- worker lifecycle ----

    def _spawn(self) -> Optional[subprocess.Popen]:
        env = dict(os.environ)
        env.update(self.env)
        env["TDAPI_WARM_PREIMPORT"] = self.preimport
        # every card of the node: a preimport that probes CUDA initialises
        # the driver, which the card guard sees (see the module doc)
        env.pop("CUDA_VISIBLE_DEVICES", None)
        try:
            return subprocess.Popen(
                [sys.executable, "-u", "-c", _WORKER_SRC],
                stdin=subprocess.PIPE, env=env,
                start_new_session=True)  # own pgid: killpg-clean, like cold
        except OSError:
            return None

    def _add_worker(self) -> None:
        with self._lock:
            if self._closed or self._gave_up:
                return
        w = self._spawn()
        if w is None:
            self._note_failure("spawn failed")
            return
        with self._lock:
            if self._closed:
                _reap(w)
                return
            self._idle.append(w)

    def _refill_async(self) -> None:
        with self._lock:
            if self._closed or self._gave_up:
                return
            delay = (min(self.backoff_cap,
                         self.backoff_base * (2 ** (self._consec_failures - 1)))
                     if self._consec_failures else 0.0)

        def refill():
            if delay:
                time.sleep(delay)
            self._add_worker()

        threading.Thread(target=refill, daemon=True).start()

    def _note_failure(self, why: str) -> None:
        with self._lock:
            self._consec_failures += 1
            if (self._consec_failures >= self.give_up_after
                    and not self._gave_up):
                self._gave_up = True
                log.warning(
                    "warm pool giving up after %d consecutive worker "
                    "failures (last: %s) — workloads fall back to cold "
                    "spawn", self._consec_failures, why)

    def _note_success(self) -> None:
        with self._lock:
            self._consec_failures = 0

    def idle_pids(self) -> list[int]:
        """The idle workers' pids (a caller may watch their warm-up)."""
        with self._lock:
            return [w.pid for w in self._idle]

    def stats(self) -> dict:
        with self._lock:
            return {"idle": len(self._idle),
                    "consecFailures": self._consec_failures,
                    "gaveUp": self._gave_up}

    # ---- dispatch ----

    # env a warm interpreter cannot honour: read once while `import torch`
    # runs and never again (the OpenMP and MKL thread pools' sizes, torch's
    # log settings), as a probe of each shows: set after the import, the
    # value does not take. Jobs setting these cold-spawn.
    IMPORT_BAKED_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "TORCH_LOGS")

    @staticmethod
    def supports(cmd: list[str], env: Optional[list[str]] = None) -> bool:
        """True for `python [-u] (-c code | -m mod | script) [args...]`.

        env is the container spec's env list: a job that sets any PYTHON*
        variable (PYTHONPATH, PYTHONHASHSEED, ...) is refused — those are
        consumed at interpreter STARTUP, which the warm worker has already
        paid, so os.environ.update can't honor them; it must cold-spawn.
        Same for the import-baked torch vars in IMPORT_BAKED_ENV. The card
        variables need no such care: CUDA reads them at its initialisation,
        which comes after the job's env is in place."""
        if not cmd or not os.path.basename(cmd[0]).startswith("python"):
            return False
        for kv in env or []:
            key = kv.partition("=")[0]
            if key.startswith("PYTHON") or key in WarmPool.IMPORT_BAKED_ENV:
                return False
        args = cmd[1:]
        while args and args[0] == "-u":
            args = args[1:]
        if not args:
            return False
        if args[0] in ("-c", "-m"):
            return len(args) >= 2
        return not args[0].startswith("-")

    def take(self) -> Optional[subprocess.Popen]:
        """Pop a live idle worker (None when the pool is empty/closed).
        Every popped worker — taken OR found dead — schedules a
        replacement, so a crashed worker can never shrink the pool
        permanently."""
        refills, taken, dead = 0, None, 0
        with self._lock:
            if self._closed:
                return None
            while self._idle:
                w = self._idle.pop()
                refills += 1
                if w.poll() is None:
                    taken = w
                    break
                dead += 1
        # dead idle workers are consecutive-failure evidence (a broken
        # preimport kills them between spawn and take); a live take resets
        for _ in range(dead):
            self._note_failure("worker died while idle")
        if taken is not None:
            self._note_success()
        for _ in range(refills):
            self._refill_async()
        return taken

    @staticmethod
    def dispatch(worker: subprocess.Popen, cmd: list[str], env: dict,
                 cwd: str, log_path: str) -> bool:
        """Hand the job line to a taken worker. False = caller must kill the
        worker and cold-spawn instead."""
        job = json.dumps({"cmd": cmd, "env": {k: str(v) for k, v in env.items()},
                          "cwd": cwd, "log": log_path})
        try:
            assert worker.stdin is not None
            worker.stdin.write(job.encode() + b"\n")
            worker.stdin.flush()
            worker.stdin.close()     # job code must see EOF on stdin
            return True
        except (OSError, ValueError, AssertionError):
            return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for w in idle:
            _reap(w)


def _reap(w: subprocess.Popen) -> None:
    try:
        if w.stdin:
            w.stdin.close()          # EOF -> clean exit
        w.wait(timeout=2)
    except (OSError, subprocess.TimeoutExpired):
        try:
            w.kill()
            w.wait(timeout=2)
        except (OSError, subprocess.TimeoutExpired):
            pass
