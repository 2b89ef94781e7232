"""Deterministic fault injection: crashpoints, transient faults and disk
faults.

The port's copy of the JAX control plane's faults.py: every crashpoint of
the services, the write-behind queue, federation, replication, the gateway
and the defragmenter, the guarded backend's transient faults, the gates of
the HTTP layer and the fleet's RPC, and the store's WAL disk faults.

**Crashpoints** are named step boundaries. One is inert until armed, by
the TDAPI_CRASHPOINTS env var (comma-separated names) or by arm(). An armed
crashpoint raises InjectedCrash, a BaseException on purpose: `except
Exception` unwind paths must not catch it, since it stands for the daemon
dying mid-step. The registry is static: crashpoint() rejects an
undeclared name, so a typo fails the first test that crosses it.

**Transient faults** make the substrate misbehave while the control plane
stays up: a backend op errors once (`error_once`), N times (`error_n:N`),
answers slowly (`latency:S`) or hangs past its deadline (`hang:S`). They
are armed per backend op by TDAPI_FAULTS (`op:mode[:arg]`, comma-separated)
or arm_fault(); GuardedBackend crosses fault_gate(op) inside its per-op
deadline. InjectedFault is a ConnectionError, a transient error by the
guard's classification, so retries and the breaker react as they would to
a flaky socket.

**Disk faults** make the store's WAL append misbehave: ENOSPC, a torn
tail, or a flipped bit (arm_disk_fault). corrupt_wal() damages a closed
WAL file offline.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time

ENV_VAR = "TDAPI_CRASHPOINTS"
FAULTS_ENV_VAR = "TDAPI_FAULTS"


class InjectedCrash(BaseException):
    """Simulated control-plane death at a named crashpoint.

    BaseException, not Exception: unwind/cleanup `except Exception`
    handlers must not observe it (a crashed daemon runs no cleanup).
    """

    def __init__(self, name: str):
        super().__init__(f"injected crash at crashpoint {name!r}")
        self.name = name


#: name -> where it sits in its mutation: the services' steps (run,
#: replace, stop, delete, volumes), the write-behind queue's, federation's
#: and replication's, the gateway's (scale-up clone, KV handoff, hedge)
#: and the defragmenter's.
CRASHPOINTS: dict[str, str] = {
    # run = grant -> create -> start -> persist
    "run.after_grant": "chips/cores granted, container not yet created",
    "run.after_create": "container created, not yet started",
    "run.after_start": "container started, latest pointer not yet persisted",
    # rolling replace (patch / rollback / restart all funnel through it)
    "replace.after_create": "new version created+persisted, old still running",
    "replace.after_quiesce": "quiesce attempt settled (workload checkpoint "
                             "parked or fallback chosen), old not yet "
                             "stopped — the QUIESCED marker is idempotent, "
                             "so recovery resumes from the same checkpoint",
    "replace.after_stop_old": "old stopped, layer not yet (delta-)copied — "
                              "the pre-copy may already have warm-copied it",
    "replace.after_copy": "layer copied, new version not yet started",
    "replace.after_start_new": "new running, old container not yet removed",
    "replace.after_remove_old": "old removed, stale grants not yet freed",
    # op-specific preambles before the shared replace machinery
    "rollback.after_grant": "historical counts re-granted, replace not begun",
    "restart.after_grant": "fresh grants applied, replace not begun",
    # gang reshard (a patch/rollback that changes a MeshPlan'd set's shape)
    "reshard.after_grant": "plan-shaped sub-mesh granted (old gang still "
                           "running on its old chips), replace not begun",
    "reshard.after_quiesce": "gang quiesce settled + reshard intent marker "
                             "written, old gang not yet stopped — recovery "
                             "rolls the persisted new version forward and "
                             "the workload re-meshes from the same "
                             "checkpoint",
    # gateway autoscale (gateway.py scale-up = a cloned run): the donor's
    # warm layer is cloned into the new replica, which is not yet started
    # and whose record is not yet persisted — a crash here must unwind the
    # half-made replica like any aborted run, never leak its grants, and
    # leave the gateway's other replicas serving
    "gwscale.after_clone": "replica layer cloned from a warm donor, new "
                           "replica not yet started",
    # stop = backend stop -> free grants -> persist resourcesReleased
    "stop.after_backend_stop": "container stopped, grants still held",
    "stop.after_restore": "grants freed, release not yet persisted",
    # delete = backend remove -> free grants -> drop store keys
    "delete.after_remove": "container removed, grants still held",
    "delete.after_restore": "grants freed, store keys not yet dropped",
    # volumes
    "volume.create.after_backend": "backend volume exists, record not persisted",
    "volume.scale.after_create": "new volume version exists, data not migrated",
    "volume.scale.after_migrate": "data migrated, old volume not yet handled",
    "volume.delete.after_remove": "backend volume removed, store keys remain",
    # write-behind persistence: the daemon dies before a queued write exists
    "workqueue.before_submit": "mutation applied in memory, persist never queued",
    # federation leases (federation.py FleetMember): the member dies
    # between the arbiter persisting a grant and the member recording /
    # acting on it; the grant is held until the lease TTL expires, when a
    # surviving ring owner steals and adopts it
    "fed.after_acquire": "grant persisted by the arbiter, member died "
                         "before recording ownership",
    "fed.after_takeover": "orphaned grant stolen, member died before "
                          "adopting the resource state",
    # promote-on-loss (FleetMember + replication.py): the taker-over dies
    # after installing the dead member's replicated records into its own
    # store but before booting the resource; the records are durable and
    # the stolen grant re-orphans, so the next sweep adopts without
    # re-promoting
    "fed.after_promote": "replicated records installed after a takeover "
                         "steal, member died before adopting/booting",
    # standby replication (replication.py StandbyReplicator): death right
    # after a replica checkpoint (replica WAL compacted, horizon sidecar
    # persisted); resume re-tails from the persisted horizon, and
    # re-applying an applied revision is a no-op (put_at / delete_at)
    "repl.after_snapshot": "replica checkpointed + horizon persisted, "
                           "replicator died before resuming the tail",
    # disaggregated KV handoff (gateway.py _forward_disagg): prefill ran
    # and the prompt KV sits exported under its key on the prefill
    # replica — the gateway dies before the decode claim. The export's
    # TTL purge frees the blocks (zero leaked KV), and the prefill claim
    # must be released by the forward's own unwind (no stuck slot)
    "kvhandoff.after_prefill": "prefill done + prompt KV exported, decode "
                               "phase never dispatched",
    # hedged requests (gateway.py _forward_hedged / workers.py): the
    # hedge replica's slot is claimed and the hedge counters are about
    # to move, but the duplicate call has not been dispatched — a crash
    # here must leak no inflight claim in either tier (the in-process
    # gateway's claim dies with the process; the worker's claim ledger
    # is reconciled by the watchdog)
    "hedge.in_flight": "hedge slot claimed, duplicate request not yet "
                       "dispatched",
    # defragmenter (defrag.py Defragmenter.run_for): the umbrella defrag
    # intent is journaled, but recovery is carried by the per-tenant
    # replace intents; after a crash at either point a re-run re-diagnoses
    # live state, skips tenants already moved, and opens the box with
    # nothing leaked
    "defrag.after_plan": "eviction plan journaled, no tenant migrated yet",
    "defrag.after_migrate": "first tenant migrated (its replace committed), "
                            "remaining evictions not yet run",
}

_lock = threading.Lock()
_armed: set[str] = set()


def all_crashpoints() -> tuple[str, ...]:
    """Every registered crashpoint name, sorted."""
    return tuple(sorted(CRASHPOINTS))


def arm(name: str) -> None:
    """Arm one crashpoint for this process (test fixture path)."""
    if name not in CRASHPOINTS:
        raise KeyError(f"unknown crashpoint {name!r}")
    with _lock:
        _armed.add(name)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def armed() -> frozenset[str]:
    with _lock:
        env = os.environ.get(ENV_VAR, "")
        names = {n.strip() for n in env.split(",") if n.strip()}
        return frozenset(_armed | names)


def crashpoint(name: str) -> None:
    """Step-boundary marker: raise InjectedCrash when `name` is armed.

    Sits on hot paths (every WorkQueue.submit), so the inert case is a few
    dict/set lookups. The env var is consulted on every crossing when set,
    so exporting it against a live daemon works."""
    if name not in CRASHPOINTS:
        raise RuntimeError(f"crashpoint {name!r} is not registered in "
                           "faults.CRASHPOINTS")
    if not _armed and not os.environ.get(ENV_VAR):
        return
    with _lock:
        hot = name in _armed
    if not hot:
        env = os.environ.get(ENV_VAR, "")
        hot = name in (n.strip() for n in env.split(","))
    if hot:
        raise InjectedCrash(name)


# --------------------------------------------------- transient faults

class InjectedFault(ConnectionError):
    """Simulated transient substrate failure at a backend op.

    ConnectionError (⊂ OSError) on purpose: the guard's transient-error
    classification — and any real error handling — must treat it exactly
    like a flaky dockerd socket or a vanished /dev/nvidia*.
    """

    def __init__(self, op: str, mode: str):
        super().__init__(f"injected {mode} fault on backend op {op!r}")
        self.op = op
        self.mode = mode


#: mode -> meaning of its optional arg (documentation + validation)
FAULT_MODES: dict[str, str] = {
    "error_once": "raise InjectedFault on the first crossing only",
    "error_n": "raise InjectedFault on the first N crossings (arg = N)",
    "latency": "sleep arg seconds (default 0.05) on every crossing, "
               "then proceed",
    "hang": "sleep arg seconds (default 2.0) on the first crossing, then "
            "raise — models a stalled call the deadline must cut",
    # duplicate-delivery injection: unlike the modes above (gated on
    # backend ops), this one is gated on HTTP endpoints — arm it on
    # 'METHOD /concrete/path' (e.g. 'POST /api/v1/replicaSet'). The
    # server EXECUTES the mutation, then severs the connection before a
    # response byte is written: the client sees a connection error and
    # cannot tell a dropped response from a dead daemon — exactly the
    # ambiguity Idempotency-Key replay resolves.
    "drop_response": "execute, then sever the connection before the "
                     "response is written, on the first N crossings "
                     "(arg = N, default 1)",
    # inter-daemon partition: PERSISTENT InjectedFault on every crossing
    # while armed — arm it on 'fed.rpc' (RestArbiter's gate) to sever a
    # member from the fleet host without touching its substrate. Unlike
    # error_n this never burns down: a partition heals by disarming, not
    # by being retried through.
    "partition": "raise InjectedFault on EVERY crossing while armed "
                 "(heals on disarm, never by retry)",
    # daemon death at a crossing: SIGKILL the CURRENT process — the real
    # thing, not InjectedCrash's unwind-free raise. For the takeover e2e:
    # arm 'fed.rpc:daemon_kill' on a member daemon and its next heartbeat
    # kills it mid-protocol, exactly how an OOM kill lands.
    "daemon_kill": "SIGKILL this process at the first crossing (arg = N "
                   "crossings to let through first, default 0)",
    # gray-failure injection (tail-tolerance e2e): a replica that is
    # SLOW-but-alive, not dead. jitter draws a heavy-tailed (Pareto)
    # latency per crossing with scale arg — most crossings add ~arg
    # seconds, the tail adds many multiples — which is the co-tenant-
    # interference shape ejection/hedging must catch. Persistent while
    # armed: a gray replica stays gray until disarmed.
    "jitter": "sleep a heavy-tailed random latency with scale arg "
              "(default 0.05) on every crossing, then proceed",
    # probabilistic flake: InjectedFault with probability arg per
    # crossing — a replica that intermittently errors without ever
    # hitting the consecutive-failure FAILED threshold. Persistent
    # while armed.
    "flaky": "raise InjectedFault with probability arg (default 0.5) "
             "per crossing",
}

_DEFAULT_ARG = {"error_once": 1.0, "error_n": 1.0, "latency": 0.05,
                "hang": 2.0, "drop_response": 1.0, "partition": 1.0,
                "daemon_kill": 0.0, "jitter": 0.05, "flaky": 0.5}


class _Fault:
    __slots__ = ("op", "mode", "arg", "remaining")

    def __init__(self, op: str, mode: str, arg: float):
        self.op = op
        self.mode = mode
        self.arg = arg
        # error_once/error_n/hang/drop_response fire a bounded number of
        # times so a retried op can converge; latency and partition are
        # persistent (a slow substrate stays slow, a partition heals by
        # disarm); daemon_kill's countdown is crossings LET THROUGH
        # before the kill lands
        self.remaining = (int(arg) if mode in ("error_n", "drop_response",
                                               "daemon_kill")
                          else 1 if mode in ("error_once", "hang")
                          else -1)


_faults: dict[str, _Fault] = {}
_faults_env_parsed = ""


def arm_fault(spec: str) -> None:
    """Arm one transient fault from an `op:mode[:arg]` spec (test path)."""
    op, _, rest = spec.partition(":")
    mode, _, arg_s = rest.partition(":")
    if not op or mode not in FAULT_MODES:
        raise ValueError(f"bad fault spec {spec!r} — want op:mode[:arg] "
                         f"with mode in {sorted(FAULT_MODES)}")
    arg = float(arg_s) if arg_s else _DEFAULT_ARG[mode]
    with _lock:
        _faults[op] = _Fault(op, mode, arg)


def disarm_faults() -> None:
    global _faults_env_parsed
    with _lock:
        _faults.clear()
        _faults_env_parsed = ""


def _ingest_env() -> None:
    """Materialize TDAPI_FAULTS into the live table (lock held). Parsed
    once per distinct env value so error_n countdowns survive crossings."""
    global _faults_env_parsed
    env = os.environ.get(FAULTS_ENV_VAR, "")
    if env == _faults_env_parsed:
        return
    _faults_env_parsed = env
    for spec in env.split(","):
        spec = spec.strip()
        if not spec:
            continue
        op, _, rest = spec.partition(":")
        mode, _, arg_s = rest.partition(":")
        if not op or mode not in FAULT_MODES or op in _faults:
            continue  # malformed entries are inert, not fatal, on a daemon
        try:
            arg = float(arg_s) if arg_s else _DEFAULT_ARG[mode]
        except ValueError:
            continue
        _faults[op] = _Fault(op, mode, arg)


def fault_gate(op: str) -> None:
    """Crossed by GuardedBackend before delegating op to the substrate.

    Inert case is one dict check under the module lock — cheap enough for
    every backend call. Sleeps happen OUTSIDE the lock so a hang on one op
    never blocks another op's gate."""
    if not _faults and not os.environ.get(FAULTS_ENV_VAR):
        return
    with _lock:
        _ingest_env()
        f = _faults.get(op)
        if f is None or f.mode == "drop_response":
            return          # drop_response is the HTTP layer's gate
        if f.mode == "daemon_kill":
            if f.remaining > 0:
                f.remaining -= 1     # crossings let through pre-kill
                return
        elif f.remaining == 0:
            return
        elif f.remaining > 0:
            f.remaining -= 1
        mode, arg = f.mode, f.arg
    if mode == "daemon_kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if mode == "latency":
        time.sleep(arg)
        return
    if mode == "jitter":
        # Pareto(α=2) scaled by arg: most crossings sleep ~arg, the tail
        # sleeps many multiples — gray, not dead. Capped at 20×arg so an
        # armed test still bounds its own runtime. The sleep runs OUTSIDE
        # the lock like every other injected delay.
        u = random.random() or 1e-9
        time.sleep(min(arg / (u ** 0.5), arg * 20.0))
        return
    if mode == "flaky":
        if random.random() < arg:
            raise InjectedFault(op, mode)
        return
    if mode == "hang":
        time.sleep(arg)
    raise InjectedFault(op, mode)


# ------------------------------------------------------------ disk faults

#: disk-fault mode -> what it does to the store's WAL append
DISK_FAULT_MODES = {
    "enospc": "fail every append with ENOSPC (the store latches read-only)",
    "torn_tail": "write half of the record, then die (arg = N appends let "
                 "through first, default 0)",
    "bitflip": "flip one bit in the record before writing it (arg = N "
               "appends let through first, default 0)",
}

_DISK_DEFAULT_ARG = {"enospc": -1.0, "torn_tail": 0.0, "bitflip": 0.0}


class _DiskFault:
    __slots__ = ("path_sub", "mode", "remaining")

    def __init__(self, path_sub: str, mode: str, remaining: int):
        self.path_sub = path_sub
        self.mode = mode
        self.remaining = remaining


_disk_faults: dict[str, _DiskFault] = {}


def arm_disk_fault(spec: str) -> None:
    """Arm one disk fault from a `path_substring:mode[:arg]` spec. The path
    substring matches the store's WAL path, so a test can target one store
    on a shared tmpdir."""
    path_sub, _, rest = spec.partition(":")
    mode, _, arg_s = rest.partition(":")
    if not path_sub or mode not in DISK_FAULT_MODES:
        raise ValueError(f"bad disk fault spec {spec!r} — want "
                         f"path_substring:mode[:arg] with mode in "
                         f"{sorted(DISK_FAULT_MODES)}")
    arg = float(arg_s) if arg_s else _DISK_DEFAULT_ARG[mode]
    # enospc is persistent (remaining -1); torn_tail/bitflip fire ONCE
    # after `arg` appends are let through
    with _lock:
        _disk_faults[path_sub] = _DiskFault(
            path_sub, mode, -1 if mode == "enospc" else int(arg))


def disarm_disk_faults() -> None:
    with _lock:
        _disk_faults.clear()


def disk_fault(path: str) -> str:
    """Crossed by the store's WAL append with the WAL path; returns the
    mode to inject ('' = none). torn_tail/bitflip consume a let-through
    countdown first, then fire once; enospc fires on every crossing."""
    if not _disk_faults:
        return ""
    with _lock:
        for f in _disk_faults.values():
            if f.path_sub not in path:
                continue
            if f.mode == "enospc":
                return f.mode
            if f.remaining > 0:
                f.remaining -= 1     # appends let through pre-fault
                return ""
            if f.remaining == 0:
                f.remaining = -2     # fired; inert until re-armed
                return f.mode
    return ""


def corrupt_wal(path: str, mode: str, line_at: float = 0.5) -> int:
    """Offline corruption of a closed WAL file, for scrub/replay tests.
    Returns the byte offset damaged.

    mode: 'torn_tail' chops the final record mid-frame; 'bitflip' flips
    one bit inside the record line at relative position `line_at` (0.0-1.0
    through the file's lines; 1.0 hits the final record)."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.splitlines(keepends=True)
    if not lines:
        raise ValueError(f"{path} is empty — nothing to corrupt")
    if mode == "torn_tail":
        last = lines[-1]
        kept = data[:len(data) - len(last)] + last[:max(1, len(last) // 2)]
        with open(path, "wb") as f:
            f.write(kept)
        return len(kept)
    if mode == "bitflip":
        # skip the magic header line; flip a bit mid-payload of the
        # chosen record so both the CRC and the JSON see the damage
        first = 1 if lines[0] == b"TDWAL1\n" else 0
        if first >= len(lines):
            raise ValueError(f"{path} has no records to corrupt")
        idx = first + min(int((len(lines) - first - 1) * line_at),
                          len(lines) - first - 1)
        off = sum(len(ln) for ln in lines[:idx])
        pos = off + len(lines[idx]) // 2
        flipped = data[:pos] + bytes([data[pos] ^ 0x01]) + data[pos + 1:]
        with open(path, "wb") as f:
            f.write(flipped)
        return pos
    raise ValueError(f"unknown corruption mode {mode!r} — want torn_tail "
                     f"or bitflip")


def should_drop_response(op: str) -> bool:
    """Crossed by the HTTP server after a handler has EXECUTED, before its
    response is written. True => sever the connection (see FAULT_MODES
    drop_response). `op` is 'METHOD /concrete/path'."""
    if not _faults and not os.environ.get(FAULTS_ENV_VAR):
        return False
    with _lock:
        _ingest_env()
        f = _faults.get(op)
        if f is None or f.mode != "drop_response" or f.remaining == 0:
            return False
        if f.remaining > 0:
            f.remaining -= 1
        return True
