"""Deterministic fault injection: crashpoints and disk faults.

The part of the JAX control plane's faults.py that the node layer crosses:
the write-behind queue's crashpoint (workqueue.py) and the store's WAL
disk faults (store/mvcc.py), with their arming. The backend's transient
faults come with the guarded backend.

**Crashpoints** are named step boundaries. One is inert until armed, by
the TDAPI_CRASHPOINTS env var (comma-separated names) or by arm(). An armed
crashpoint raises InjectedCrash, a BaseException on purpose: `except
Exception` unwind paths must not catch it, since it stands for the daemon
dying mid-step. The registry is static: crashpoint() rejects an
undeclared name, so a typo fails the first test that crosses it.

**Disk faults** make the store's WAL append misbehave: ENOSPC, a torn
tail, or a flipped bit (arm_disk_fault). corrupt_wal() damages a closed
WAL file offline.
"""

from __future__ import annotations

import os
import threading

ENV_VAR = "TDAPI_CRASHPOINTS"


class InjectedCrash(BaseException):
    """Simulated control-plane death at a named crashpoint.

    BaseException, not Exception: unwind/cleanup `except Exception`
    handlers must not observe it (a crashed daemon runs no cleanup).
    """

    def __init__(self, name: str):
        super().__init__(f"injected crash at crashpoint {name!r}")
        self.name = name


#: name -> where it sits in its mutation. Later slices of the control
#: plane add theirs (the services' run/replace/stop/delete steps).
CRASHPOINTS: dict[str, str] = {
    "workqueue.before_submit": "mutation applied in memory, persist never queued",
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
