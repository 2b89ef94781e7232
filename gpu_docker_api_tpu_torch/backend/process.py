"""Process substrate: containers are real host processes.

The port's copy of the JAX control plane's backend/process.py, for an
NVIDIA node. Where the reference's real backend shells containers into
dockerd (internal/services/replicaset_nomock.go), this backend launches
the workload command directly with:

- the card env grant from the card scheduler (CUDA_VISIBLE_DEVICES under
  CUDA_DEVICE_ORDER=PCI_BUS_ID, the worker contract, TDAPI_MESH_PLAN):
  the grant alone decides which cards a container sees, never the
  daemon's own CUDA_VISIBLE_DEVICES;
- a private rootfs dir per container version (the overlay2 upper-dir analog
  that rolling replacement copies forward),
- bind "mounts" realized as symlinks inside the rootfs,
- stdout/stderr captured to a per-container log.

CPU pinning uses `taskset` when available. Memory limits are ENFORCED on
two levels (see _apply_memory_limit): RLIMIT_DATA on the child, as JAX's
backend does, and a watchdog that kills a container whose process holds
more private data memory than its grant (the same accounting, VmData).
The watchdog is what enforces the grant on kernels that set RLIMIT_DATA
without enforcing it (gVisor). Pause/continue are SIGSTOP/SIGCONT — the
exact process-level analog of docker pause (which freezes the cgroup).

With `warm_pool > 0` Python workloads start on a pre-imported torch
interpreter (warmpool.py), which takes the job's card grant because CUDA
is still uninitialised there; a worker that finds it initialised starts
the job cold.
"""

from __future__ import annotations

import logging
import os
import resource
import shutil
import signal
import subprocess
import tarfile
import threading
import time
import uuid
from typing import Optional

from ..dtos import ContainerSpec
from .base import Backend, ContainerState, VolumeState, device_path_available

log = logging.getLogger(__name__)


def _run_quiet(cmd: list[str], timeout: float = 30.0, events=None,
               label: str = "") -> bool:
    """Run a host tool, True on rc 0; missing binary / failure = False.

    A TIMEOUT is not silent like the other failures: a mount/umount that
    stalls for 30s is a substrate symptom (dying disk, wedged loop device)
    the operator must be able to see — it is logged and, when the caller
    wires an EventLog, emitted as a backend.tool_timeout event on
    /api/v1/events."""
    try:
        return subprocess.run(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=timeout).returncode == 0
    except subprocess.TimeoutExpired:
        log.warning("host tool timed out after %.0fs: %s",
                    timeout, " ".join(cmd))
        if events is not None:
            try:
                events.record("backend.tool_timeout",
                              target=label or os.path.basename(cmd[0]),
                              code=500, tool=" ".join(cmd),
                              timeoutSec=timeout)
            except Exception:  # noqa: BLE001 — observability must not kill
                log.exception("recording tool-timeout event")
        return False
    except OSError:
        return False


def _quota_bytes(quota: str) -> int:
    """'30G'/'30GB' -> bytes; 0 for empty/unparseable (no enforcement).
    Accepts docker StorageOpt-style single-letter units (the reference's
    `size=30G`, replicaset.go:67-71) on top of utils ToBytes units."""
    s = (quota or "").strip().upper()
    if not s:
        return 0
    if s[-1] in "KMGT" and (len(s) < 2 or s[-2] not in "KMGT"):
        s += "B"
    from ..utils.file import to_bytes
    try:
        return to_bytes(s)
    except ValueError:
        return 0


class _Proc:
    def __init__(self, name: str, spec: ContainerSpec, rootfs: str, log_path: str):
        self.id = uuid.uuid4().hex[:12]
        self.name = name
        self.spec = spec
        self.rootfs = rootfs
        self.log_path = log_path
        self.popen: Optional[subprocess.Popen] = None
        self.paused = False
        self.started_at = 0.0
        self.exit_code: Optional[int] = None
        # supervision state (restart policy + storage watchdog)
        self.user_stopped = False     # stop() was asked for — no restart
        self.restart_count = 0
        self.restart_at = 0.0         # 0 = no restart pending
        self.quota_check_at = 0.0     # next rootfs usage poll
        self.quota_exceeded = False


#: the variable a card grant writes; the daemon's own never leaks through
VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

#: the memory watchdog's poll period: a container over its grant is
#: killed within about this long
MEMORY_POLL_S = 0.05


class ProcessBackend(Backend):
    def __init__(self, state_dir: str, warm_pool: int = 0,
                 warm_preimport: str = "torch", supervise: bool = False,
                 supervise_interval: float = 0.3,
                 forgive_after: float = 10.0,
                 warm_env: Optional[dict] = None):
        self.state_dir = state_dir
        self._lock = threading.RLock()
        self._procs: dict[str, _Proc] = {}
        # optional EventLog; the App wires it so quota mount/umount stalls
        # surface on /api/v1/events (see _run_quiet)
        self.events = None
        # stop() escalations to SIGKILL — workloads that ignored SIGTERM
        # for the whole stop timeout; exported as tdapi_backend_stop_kills
        self.stop_kills = 0
        for sub in ("rootfs", "volumes", "images", "logs"):
            os.makedirs(os.path.join(state_dir, sub), exist_ok=True)
        # warm worker pool (warmpool.py): python workloads start in a
        # pre-imported interpreter, skipping startup+`import torch` on the
        # cold-start critical path. 0 = off. warm_env is the workers' own
        # environment (e.g. the PYTHONPATH a job's env may not set).
        self._pool = None
        if warm_pool > 0:
            from .warmpool import WarmPool
            self._pool = WarmPool(size=warm_pool, preimport=warm_preimport,
                                  env=warm_env)
        # memory watchdog: {pid: (limit bytes, whole process group?)} of
        # every memory-limited container and exec while it runs; its thread
        # starts with the first such process
        self._mem_lock = threading.Lock()
        self._mem_watch: dict[int, tuple[int, bool]] = {}
        self._mem_thread: Optional[threading.Thread] = None
        # containers and execs the watchdog killed over their grant;
        # exported like stop_kills
        self.memory_kills = 0
        # the watchdog's own load: its polls, and the CPU seconds its
        # thread has spent (thread_time at its latest poll)
        self.memory_polls = 0
        self.memory_watch_cpu_s = 0.0
        # loopback-fs volume quota capability: None = not probed yet
        self._loopfs: Optional[bool] = None
        self._closed = False
        # supervision (the daemon turns this on; unit substrates keep it
        # off so exited test containers stay exited): restart_policy
        # enforcement — the reference gets `unless-stopped` from dockerd
        # (replicaset.go:73-75), a host-process substrate must supervise
        # itself — plus the rootfs storage-quota watchdog (the fallback
        # enforcement where no filesystem quota exists for a plain dir).
        self._interval = supervise_interval
        # a container healthy for this long has its restart_count forgiven,
        # so a much-later crash restarts promptly instead of inheriting a
        # 30s backoff (tests shrink it to avoid real 10s waits)
        self._forgive_after = forgive_after
        self._supervisor = None
        self._remount_quota_volumes()
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True,
                name="process-backend-supervisor")
            self._supervisor.start()
            # rootfs-quota polling walks whole rootfs trees (IO-bound) —
            # its own thread, so a slow walk never delays crash detection
            # or a scheduled restart
            threading.Thread(target=self._quota_watch, daemon=True,
                             name="process-backend-quota-watch").start()

    # ---- containers ----

    def create(self, name: str, spec: ContainerSpec) -> str:
        with self._lock:
            if name in self._procs:
                raise RuntimeError(f"container {name} already exists")
            rootfs = os.path.join(self.state_dir, "rootfs", name)
            os.makedirs(rootfs, exist_ok=True)
            # "image": a committed tarball seeds the rootfs (commit/run cycle)
            img_tar = self._image_path(spec.image)
            if img_tar and os.path.exists(img_tar):
                with tarfile.open(img_tar) as t:
                    t.extractall(rootfs, filter="data")
            self._materialize_binds(rootfs, spec.binds)
            p = _Proc(name, spec, rootfs,
                      os.path.join(self.state_dir, "logs", f"{name}.log"))
            self._procs[name] = p
            return p.id

    def _materialize_binds(self, rootfs: str, binds: list[str]) -> None:
        """Bind "mounts": symlink rootfs/{dest} -> src. Workloads address
        their data at {rootfs}{dest} (or via $CONTAINER_ROOT)."""
        for b in binds:
            src, _, dest = b.partition(":")
            if not src or not dest:
                continue
            link = os.path.join(rootfs, dest.lstrip("/"))
            os.makedirs(os.path.dirname(link), exist_ok=True)
            if os.path.islink(link) or os.path.exists(link):
                if os.path.islink(link):
                    os.unlink(link)
                else:
                    continue
            os.symlink(os.path.abspath(src), link)

    def start(self, name: str) -> None:
        with self._lock:
            p = self._get(name)
            if p.popen is not None and p.popen.poll() is None:
                return
            # a stale quiesce ack (prior quiesce, or one cloned in by the
            # replace layer copy) must not let a future quiesce() read a
            # dead workload's acknowledgment as this run's
            try:
                os.unlink(os.path.join(p.rootfs, self.QUIESCE_ACK))
            except OSError:
                pass
            env = self._build_env(p)
            cmd = list(p.spec.cmd) or ["sleep", "infinity"]
            p.popen = self._start_warm(p, cmd, env)
            if p.popen is None:
                if p.spec.cpuset and shutil.which("taskset"):
                    cmd = ["taskset", "-c", p.spec.cpuset] + cmd
                with open(p.log_path, "ab") as logf:
                    p.popen = subprocess.Popen(
                        cmd, cwd=p.rootfs, env=env, stdout=logf,
                        stderr=subprocess.STDOUT,
                        start_new_session=True)  # own pgid for signaling
            self._apply_memory_limit(p.popen.pid, p.spec.memory_bytes,
                                     group=True)
            p.started_at = time.time()
            p.paused = False
            p.exit_code = None
            p.user_stopped = False
            p.restart_at = 0.0

    @property
    def pool(self):
        """The warm worker pool (warmpool.WarmPool), or None without one."""
        return self._pool

    def _start_warm(self, p: _Proc, cmd: list[str], env: dict):
        """Try to run the container on a warm pool worker; None -> cold
        spawn. The worker becomes the container process (its Popen is kept),
        so stop/pause/inspect work identically. CPU pinning that the cold
        path does with a taskset wrapper is applied here via
        sched_setaffinity on the live worker."""
        if self._pool is None or not self._pool.supports(cmd, p.spec.env):
            return None
        w = self._pool.take()
        if w is None:
            return None
        if not self._pool.dispatch(w, cmd, env, p.rootfs, p.log_path):
            from .warmpool import _reap
            _reap(w)
            return None
        if p.spec.cpuset:
            try:
                cpus = {int(c) for c in p.spec.cpuset.split(",") if c.strip()}
                os.sched_setaffinity(w.pid, cpus)
            except (OSError, ValueError):
                pass  # already exited / bad set: same tolerance as taskset
        return w

    def stop(self, name: str, timeout: float = 10.0) -> None:
        with self._lock:
            p = self._get(name)
            p.user_stopped = True   # an explicit stop never auto-restarts
            po = p.popen
        if po is None or po.poll() is not None:
            if po is not None:
                p.exit_code = po.returncode
                self._unwatch(po.pid)
            return
        try:
            os.killpg(po.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            po.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            # escalation is an operator-visible symptom, never silent: the
            # workload ignored SIGTERM for the whole stop window (wedged
            # checkpoint write, masked signal, stuck device teardown)
            self.stop_kills += 1
            log.warning("stop: %s ignored SIGTERM for %.0fs — escalating "
                        "to SIGKILL", name, timeout)
            self._log_line(p, f"supervisor: SIGTERM ignored for {timeout:.0f}s"
                              " — escalating to SIGKILL")
            if self.events is not None:
                try:
                    self.events.record("backend.stop_killed", target=name,
                                       code=500, timeoutSec=timeout)
                except Exception:  # noqa: BLE001 — observability must not kill
                    log.exception("recording stop_killed event")
            try:
                os.killpg(po.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            po.wait(timeout=5)
        p.exit_code = po.returncode
        self._unwatch(po.pid)

    def quiesce(self, name: str, timeout: float = 30.0) -> bool:
        """Checkpoint-now: SIGUSR1 to the container's process group, then
        wait for the workload's `.quiesced` ack at the rootfs root (the
        contract in base.py / train.py). A workload that dies instead of
        parking (no handler installed — SIGUSR1's default action is
        terminate) reads as not-quiesced, and the caller's plain stop
        still converges."""
        with self._lock:
            p = self._procs.get(name)
            if p is None:
                return False
            po = p.popen
            if po is None or po.poll() is not None or p.paused:
                return False
            ack = os.path.join(p.rootfs, self.QUIESCE_ACK)
        try:
            os.unlink(ack)        # a stale ack must not satisfy this wait
        except OSError:
            pass
        try:
            os.killpg(po.pid, signal.SIGUSR1)
        except ProcessLookupError:
            return False
        deadline = time.time() + max(0.0, timeout)
        while time.time() < deadline:
            if os.path.exists(ack):
                return True
            if po.poll() is not None:
                return False      # died on the signal: no ack is coming
            time.sleep(0.02)
        return os.path.exists(ack)

    def pause(self, name: str) -> None:
        with self._lock:
            p = self._get(name)
            if p.popen is not None and p.popen.poll() is None:
                os.killpg(p.popen.pid, signal.SIGSTOP)
                p.paused = True

    def restart_inplace(self, name: str) -> None:
        """Reference Continue = `docker restart` (replicaset.go:717-732):
        resume if paused, else stop+start the same container."""
        with self._lock:
            p = self._get(name)
            if p.paused and p.popen is not None and p.popen.poll() is None:
                os.killpg(p.popen.pid, signal.SIGCONT)
                p.paused = False
                return
        self.stop(name, timeout=5)
        self.start(name)

    # ---- supervision (restart policy + storage watchdog) ----

    def _supervise(self) -> None:
        while not self._closed:
            time.sleep(self._interval)
            with self._lock:
                items = list(self._procs.items())
            for name, p in items:
                try:
                    self._supervise_one(name, p)
                except Exception:  # noqa: BLE001 — supervision must outlive
                    pass           # any single container's weirdness

    def _supervise_one(self, name: str, p: _Proc) -> None:
        po = p.popen
        if po is None:
            return
        now = time.time()
        rc = po.poll()
        if rc is None:
            # running healthily for a stretch: forgive the backoff history
            if p.restart_count and now - p.started_at > self._forgive_after:
                p.restart_count = 0
            return
        if p.user_stopped or p.quota_exceeded:
            return
        pol = p.spec.restart_policy or "no"
        if pol == "no" or (pol == "on-failure" and rc == 0):
            return
        if pol not in ("always", "unless-stopped", "on-failure"):
            return
        if not p.restart_at:                       # death just observed
            delay = min(30.0, 0.25 * (2 ** min(p.restart_count, 7)))
            p.restart_at = now + delay
            return
        if now < p.restart_at:
            return
        with self._lock:
            cur = self._procs.get(name)
            # re-check under the lock: remove() may have dropped the proc
            # AND nulled p.popen since the unlocked poll above — the None
            # guard is explicit because the old `p.popen.poll()` raised
            # AttributeError here, silently eaten by _supervise's blanket
            # except, leaving the restart permanently pending
            po_now = p.popen
            if (cur is not p or p.user_stopped or po_now is None
                    or po_now.poll() is None):
                return                             # raced a user action
            p.restart_at = 0.0
            p.restart_count += 1
            self._log_line(p, f"supervisor: restarting (policy={pol}, "
                              f"exit={rc}, attempt={p.restart_count})")
            self.start(name)

    def _quota_watch(self) -> None:
        while not self._closed:
            time.sleep(min(1.0, self._interval * 4))
            with self._lock:
                items = list(self._procs.items())
            for name, p in items:
                try:
                    if p.popen is not None and p.popen.poll() is None:
                        self._enforce_rootfs_quota(name, p, time.time())
                except Exception:  # noqa: BLE001
                    pass

    def _enforce_rootfs_quota(self, name: str, p: _Proc, now: float) -> None:
        """Storage-quota watchdog for the rootfs dir. The reference gets
        hard rootfs quota from overlay2-on-XFS (`StorageOpt size=30G`,
        replicaset.go:67-71); a plain host directory has no filesystem
        quota, so enforcement here is supervisory: poll usage (throttled),
        kill the workload on breach, and never restart it (a restart would
        be killed again at the same frontier). Volumes get REAL ENOSPC
        quota via loopback images (volume_create)."""
        if now < p.quota_check_at:
            return
        p.quota_check_at = now + 2.0
        limit = _quota_bytes(p.spec.rootfs_quota)
        if not limit:
            return
        from ..utils.file import dir_size
        used = dir_size(p.rootfs)
        if used <= limit:
            return
        p.quota_exceeded = True
        self._log_line(
            p, f"supervisor: rootfs storage quota exceeded "
               f"({used} > {limit} bytes) — killing container")
        try:
            self.stop(name, timeout=2.0)
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _log_line(p: _Proc, msg: str) -> None:
        try:
            with open(p.log_path, "ab") as f:
                f.write((msg + "\n").encode())
        except OSError:
            pass

    def remove(self, name: str, force: bool = False) -> None:
        with self._lock:
            p = self._procs.get(name)
            if p is None:
                return
            running = p.popen is not None and p.popen.poll() is None
            if running and not force:
                raise RuntimeError(f"container {name} is running")
        if p.popen is not None and p.popen.poll() is None:
            self.stop(name, timeout=2)
        with self._lock:
            shutil.rmtree(p.rootfs, ignore_errors=True)
            if os.path.exists(p.log_path):
                os.unlink(p.log_path)
            self._procs.pop(name, None)
            # a supervisor tick holding a stale _Proc must see the removal
            p.popen = None

    def execute(self, name: str, cmd: list[str], workdir: str = "") -> tuple[int, str]:
        with self._lock:
            p = self._get(name)
            running = p.popen is not None and p.popen.poll() is None
            if not running:
                return 1, "container not running"
            env = self._build_env(p)
            cwd = os.path.join(p.rootfs, workdir.lstrip("/")) if workdir else p.rootfs
        try:
            # execs share the container's memory grant (docker exec runs in
            # the same cgroup as -m; same story here)
            proc = subprocess.Popen(
                cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            return 127, str(e)
        self._apply_memory_limit(proc.pid, p.spec.memory_bytes)
        try:
            out, _ = proc.communicate(timeout=300)
            return proc.returncode, out or ""
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return 124, "exec timed out"
        finally:
            self._unwatch(proc.pid)

    def inspect(self, name: str) -> ContainerState:
        with self._lock:
            p = self._procs.get(name)
            if p is None:
                return ContainerState(name=name, exists=False)
            running = p.popen is not None and p.popen.poll() is None
            if p.popen is not None and not running:
                p.exit_code = p.popen.returncode
                self._unwatch(p.popen.pid)
            return ContainerState(
                name=name, exists=True, running=running, paused=p.paused,
                exit_code=p.exit_code, spec=p.spec, upper_dir=p.rootfs,
                started_at=p.started_at,
                pid=p.popen.pid if running else None)

    def commit(self, name: str, new_image: str) -> str:
        with self._lock:
            p = self._get(name)
            tar_path = self._image_path(new_image, create_dirs=True)
            with tarfile.open(tar_path, "w") as t:
                t.add(p.rootfs, arcname=".")
            return "sha256:" + uuid.uuid4().hex

    def list_names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._procs if n.startswith(prefix))

    # ---- health hooks ----

    def chip_available(self, device_path: str) -> bool:
        """A card whose /dev/nvidia<minor> node vanished (PCIe drop,
        driver reset) is unusable; a host with no card node at all runs a
        virtual topology and reports healthy (base.py)."""
        return device_path_available(device_path)

    def flap_counts(self) -> dict[str, int]:
        """Supervisor restart counters: a container crash-looping under
        restart policy shows up here until forgive_after clears it."""
        with self._lock:
            return {n: p.restart_count for n, p in self._procs.items()
                    if p.restart_count > 0}

    # ---- volumes ----

    def volume_create(self, name: str, size_bytes: int = 0,
                      tier: str = "") -> VolumeState:
        from .base import resolve_tier_root
        with self._lock:
            root = resolve_tier_root(
                os.path.join(self.state_dir, "volumes"),
                getattr(self, "volume_tiers", {}), tier)
            os.makedirs(root, exist_ok=True)
            mp = os.path.join(root, name)
            if os.path.exists(mp) or self._find_volume(name):
                raise RuntimeError(f"volume {name} already exists")
            if size_bytes:
                # quota lives in its OWN namespace (a volume named
                # ".quotas" must not collide). The overlay2-XFS `size=`
                # analog (volume.go:36-38); hard-enforced below via a
                # loopback ext4 image when the host allows mounts, else
                # the SERVICE layer's used-vs-limit guard is the
                # documented fallback.
                os.makedirs(self._quota_dir, exist_ok=True)
                with open(os.path.join(self._quota_dir, name), "w") as f:
                    f.write(str(int(size_bytes)))
            try:
                os.makedirs(mp)
            except OSError:
                # no orphaned quota: a later quota-less recreate must not
                # silently inherit this one
                if size_bytes:
                    try:
                        os.unlink(os.path.join(self._quota_dir, name))
                    except OSError:
                        pass
                raise
        # mkfs/mount run OUTSIDE the lock: the name is already reserved
        # (mp exists), and a slow mkfs must not stall every container op
        # and the supervisor behind the backend lock
        enforced = bool(size_bytes) and self._mount_quota_fs(
            name, mp, int(size_bytes))
        return VolumeState(name=name, exists=True, mountpoint=mp,
                           size_limit_bytes=size_bytes, tier=tier,
                           driver_opts={"size": size_bytes,
                                        "enforced": enforced})

    # ---- loopback quota filesystems (hard ENOSPC enforcement) ----

    def _loopfs_capable(self) -> bool:
        """One-time probe: can this host mkfs+loop-mount? (Root on a TPU
        VM: yes. Sandboxed CI: usually no — fall back to the advisory
        service-layer guard.)"""
        if self._loopfs is None:
            probe = os.path.join(self.state_dir, ".loopfs-probe")
            img, mnt = probe + ".img", probe + ".mnt"
            ok = False
            try:
                os.makedirs(mnt, exist_ok=True)
                with open(img, "wb") as f:
                    f.truncate(8 << 20)
                ok = (_run_quiet(["mkfs.ext4", "-q", "-F", img])
                      and _run_quiet(["mount", "-o", "loop", img, mnt]))
                if ok:
                    _run_quiet(["umount", mnt])
            finally:
                for path in (img,):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                try:
                    os.rmdir(mnt)
                except OSError:
                    pass
            self._loopfs = ok
        return self._loopfs

    # smallest loopback image ext4 can lay metadata out in; a quota below
    # this can't be hard-enforced (the fs would allow ~8MB regardless), so
    # it honestly stays advisory instead of reporting a wrong limit
    _LOOPFS_FLOOR = 8 << 20

    def _mount_quota_fs(self, name: str, mp: str, size_bytes: int) -> bool:
        """Back the volume dir with a loop-mounted ext4 image of exactly
        the quota size: a workload writing past the limit gets a real
        ENOSPC from the kernel — the TPU-VM-native analog of the
        reference's overlay2-XFS `size=` option. False -> stay a plain
        dir (advisory quota)."""
        if size_bytes < self._LOOPFS_FLOOR or not self._loopfs_capable():
            return False
        os.makedirs(self._volimg_dir, exist_ok=True)
        img = os.path.join(self._volimg_dir, f"{name}.img")
        try:
            with open(img, "wb") as f:
                # sparse image: disk is consumed as the volume fills, the
                # fs SIZE (the quota) is fixed
                f.truncate(size_bytes)
            if not _run_quiet(["mkfs.ext4", "-q", "-F", img],
                              events=self.events, label=name):
                raise OSError("mkfs.ext4 failed")
            if not _run_quiet(["mount", "-o", "loop", img, mp],
                              events=self.events, label=name):
                raise OSError("loop mount failed")
            # the workload writes as the container's uid; lost+found stays
            os.chmod(mp, 0o777)
            return True
        except OSError:
            try:
                os.unlink(img)
            except OSError:
                pass
            return False

    def _remount_quota_volumes(self) -> None:
        """Daemon restart: close() unmounted every quota volume, so remount
        any image whose volume dir still exists — otherwise prior data
        stays trapped in the image and new writes land unquota'd."""
        if not os.path.isdir(self._volimg_dir):
            return
        for f in os.listdir(self._volimg_dir):
            if not f.endswith(".img"):
                continue
            found = self._find_volume(f[:-4])
            if found and not os.path.ismount(found[0]):
                img = os.path.join(self._volimg_dir, f)
                _run_quiet(["mount", "-o", "loop", img, found[0]],
                           events=self.events, label=f[:-4])

    def _unmount_quota_fs(self, mp: str, name: str) -> None:
        if os.path.ismount(mp):
            if not _run_quiet(["umount", mp], events=self.events, label=name):
                # lazy: busy writer
                _run_quiet(["umount", "-l", mp],
                           events=self.events, label=name)
        try:
            os.unlink(os.path.join(self._volimg_dir, f"{name}.img"))
        except OSError:
            pass

    def _find_volume(self, name: str):
        """(mountpoint, tier) across the default root and every configured
        tier root, or None."""
        mp = os.path.join(self.state_dir, "volumes", name)
        if os.path.isdir(mp):
            return mp, ""
        for tier, root in getattr(self, "volume_tiers", {}).items():
            mp = os.path.join(root, "tpu-volumes", name)
            if os.path.isdir(mp):
                return mp, tier
        return None

    def volume_remove(self, name: str) -> None:
        found = self._find_volume(name)
        if found:
            self._unmount_quota_fs(found[0], name)
            shutil.rmtree(found[0], ignore_errors=True)
        try:
            os.unlink(os.path.join(self._quota_dir, name))
        except OSError:
            pass

    def volume_list(self) -> list[str]:
        out = set()
        root = os.path.join(self.state_dir, "volumes")
        if os.path.isdir(root):
            out.update(d for d in os.listdir(root)
                       if os.path.isdir(os.path.join(root, d)))
        for tier_root in getattr(self, "volume_tiers", {}).values():
            managed = os.path.join(tier_root, "tpu-volumes")
            if os.path.isdir(managed):
                out.update(d for d in os.listdir(managed)
                           if os.path.isdir(os.path.join(managed, d)))
        return sorted(out)

    def volume_inspect(self, name: str) -> VolumeState:
        from ..utils.file import dir_size
        found = self._find_volume(name)
        if not found:
            return VolumeState(name=name, exists=False)
        mp, tier = found
        limit = 0
        try:
            with open(os.path.join(self._quota_dir, name)) as f:
                limit = int(f.read().strip() or 0)
        except (OSError, ValueError):
            pass
        return VolumeState(name=name, exists=True, mountpoint=mp,
                           size_limit_bytes=limit, tier=tier,
                           used_bytes=dir_size(mp))

    # ---- lifecycle ----

    def close(self) -> None:
        self._closed = True
        for name in self.list_names():
            try:
                self.stop(name, timeout=2)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if self._pool is not None:
            self._pool.close()
        # release loop mounts (the images and volume dirs persist — a
        # restarted daemon's volume_create/--state-dir reuse finds them)
        if os.path.isdir(self._volimg_dir):
            for f in os.listdir(self._volimg_dir):
                if not f.endswith(".img"):
                    continue
                found = self._find_volume(f[:-4])
                if found and os.path.ismount(found[0]):
                    if not _run_quiet(["umount", found[0]]):
                        _run_quiet(["umount", "-l", found[0]])

    # ---- helpers ----

    def _apply_memory_limit(self, pid: int, memory_bytes: int,
                            group: bool = False) -> None:
        """Memory grant ENFORCED, not advisory, on two levels.

        RLIMIT_DATA, set by prlimit from the PARENT right after spawn (no
        post-fork Python: preexec_fn can deadlock a threaded daemon on
        allocator locks): brk and private writable mappings, the closest
        host-process analog of `docker run -m` that does not kill runtimes
        for merely RESERVING address space. A CUDA process initialises
        under it: CUDA's large reservations are not writable private data.

        The watchdog (_watch_memory): a kernel may set the limit without
        enforcing it (the gVisor sandbox of the card's host does), so
        a poll kills the container (its process group; for an exec, the
        exec) once any of its processes holds more VmData, the same
        private-data count, than the grant. Where the kernel enforces the
        limit, VmData never passes it and the watchdog never fires."""
        if not memory_bytes:
            return
        lim = int(memory_bytes)
        try:
            resource.prlimit(pid, resource.RLIMIT_DATA, (lim, lim))
        except (ProcessLookupError, PermissionError):
            pass    # already exited / restricted: the wait() sees it
        with self._mem_lock:
            self._mem_watch[pid] = (lim, group)
            if self._mem_thread is None:
                self._mem_thread = threading.Thread(
                    target=self._watch_memory, daemon=True,
                    name="process-backend-memory-watch")
                self._mem_thread.start()

    def _unwatch(self, pid: int) -> None:
        with self._mem_lock:
            self._mem_watch.pop(pid, None)

    def _watch_memory(self) -> None:
        """One pass over /proc a tick, whatever the number of containers:
        the process groups of every watched container come from a single
        walk, and nothing is walked while no container is watched."""
        while not self._closed:
            time.sleep(MEMORY_POLL_S)
            with self._mem_lock:
                watched = list(self._mem_watch.items())
            if watched:
                self._memory_pass(watched)
            self.memory_polls += 1
            self.memory_watch_cpu_s = time.thread_time()

    def _memory_pass(self, watched: list) -> None:
        groups = (_process_groups()
                  if any(group for _, (_, group) in watched) else {})
        for pid, (limit, group) in watched:
            pids = groups.get(pid, []) if group else [pid]
            if not pids:
                self._unwatch(pid)     # the whole group has exited
                continue
            over = _over_limit(pids, limit)
            if over is None:
                continue
            with self._mem_lock:
                if self._mem_watch.pop(pid, None) is None:
                    continue           # unwatched meanwhile: exited
            try:
                if group:
                    os.killpg(pid, signal.SIGKILL)
                else:
                    os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                continue
            self.memory_kills += 1
            msg = (f"supervisor: memory grant exceeded (pid {over[0]} "
                   f"holds {over[1]} > {limit} bytes of data) — killed")
            log.warning("%s", msg)
            with self._lock:
                procs = [p for p in self._procs.values()
                         if p.popen is not None and p.popen.pid == pid]
            for p in procs:
                self._log_line(p, msg)

    @property
    def _quota_dir(self) -> str:
        return os.path.join(self.state_dir, "volume_quotas")

    @property
    def _volimg_dir(self) -> str:
        return os.path.join(self.state_dir, "volume_images")

    @staticmethod
    def _build_env(p: _Proc) -> dict:
        """The ONE environment a container's main process and execs share:
        daemon env + spec env + card grant + CONTAINER_ROOT + port grants.

        Cards: the daemon's own CUDA_VISIBLE_DEVICES is never inherited
        (the daemon may see every card of the node); the grant's value
        overrides the spec's; a container with neither sees no card ("").

        Port grants: docker NATs containerPort->hostPort; a host process
        can't be NATed, so the workload binds the granted HOST port
        directly — HOST_PORT_{containerPort}=hostPort per binding, plus
        PORT for the FIRST-DECLARED container port (dict preserves the
        request's containerPorts order). Only a PORT set explicitly in the
        spec's own env overrides that; one inherited from the daemon's
        environment must not leak into workloads."""
        env = dict(os.environ)
        env.pop(VISIBLE_DEVICES, None)
        spec_keys = set()
        for kv in p.spec.env:
            k, _, v = kv.partition("=")
            env[k] = v
            spec_keys.add(k)
        env.update(p.spec.tpu_env)
        env.setdefault(VISIBLE_DEVICES, "")
        env["CONTAINER_ROOT"] = p.rootfs
        first = None
        for cp, hp in p.spec.port_bindings.items():
            env[f"HOST_PORT_{cp}"] = str(hp)
            if first is None:
                first = hp
        if first is not None and "PORT" not in spec_keys:
            env["PORT"] = str(first)
        return env

    def _image_path(self, image: str, create_dirs: bool = False) -> str:
        if not image:
            return ""
        safe = image.replace("/", "_").replace(":", "_")
        path = os.path.join(self.state_dir, "images", f"{safe}.tar")
        if create_dirs:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def wait(self, name: str, timeout: Optional[float] = None) -> int:
        """Block until the container's process exits; its exit code.
        Raises subprocess.TimeoutExpired after `timeout` seconds."""
        with self._lock:
            po = self._get(name).popen
        if po is None:
            raise RuntimeError(f"container {name} was never started")
        po.wait(timeout=timeout)
        return self.inspect(name).exit_code

    def log_text(self, name: str) -> str:
        """What the container has written to its stdout and stderr, with
        the supervisor's own lines."""
        with self._lock:
            path = self._get(name).log_path
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def _get(self, name: str) -> _Proc:
        p = self._procs.get(name)
        if p is None:
            raise RuntimeError(f"no such container {name}")
        return p


def _vm_data(pid: int) -> int:
    """A process's private data memory (VmData, bytes); 0 once it is gone."""
    try:
        with open(f"/proc/{pid}/status", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("VmData:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def _process_groups() -> dict[int, list[int]]:
    """{pgid: [pid, ...]} of every process on the host, from one walk of
    /proc."""
    out: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", encoding="ascii",
                      errors="replace") as f:
                # pgrp is the 3rd field after the parenthesised comm
                pgid = int(f.read().rsplit(")", 1)[1].split()[2])
        except (OSError, ValueError, IndexError):
            continue
        out.setdefault(pgid, []).append(int(d))
    return out


def _over_limit(pids: list[int], limit: int) -> Optional[tuple[int, int]]:
    """(pid, VmData) of the first process over `limit`, or None."""
    for q in pids:
        used = _vm_data(q)
        if used > limit:
            return q, used
    return None
