"""Fast data movement: CoW cloning, parallel copy, snapshot/delta sync.

The port's copy of the JAX control plane's utils/copyfast.py, unchanged.

Every mutation in the ReplicaSet model is a rolling replacement whose
downtime window used to be `stop old -> copy writable layer -> start new`,
with the copy a single-threaded byte-at-a-time walk executed entirely
inside the window — patch/rollback/drain latency was O(layer bytes) while
the chips sat idle. This module makes every layer/volume move cost what
the filesystem can do, not what a serial Python loop can do:

- **clone_tree** — recursive tree copy through a mode ladder:
  reflink (`FICLONE` ioctl: CoW clone, O(metadata) on btrfs/xfs) →
  `os.copy_file_range` (server-side copy: no user-space bounce, works on
  tmpfs/overlayfs same-FS) → a multi-threaded `copy2` pool (sendfile under
  the hood releases the GIL, so threads genuinely parallelize; the
  cross-FS fallback). The first file that a rung refuses demotes the
  ladder for the rest of the tree. Preserves the rolling-replace
  "symlink-wins" semantics (an existing symlink in dest is a materialized
  bind mount and must win over the old layer's content) and copies
  directory metadata (`copystat`), which the seed copy dropped.
- **snapshot_tree / delta_sync** — the pre-copy protocol: snapshot the
  source's (size, mtime_ns) per file while the old container is still
  running, warm-copy everything, then after `stop old` re-copy only the
  files dirtied since the snapshot and delete the ones removed in
  between. The downtime window shrinks from O(layer) to O(dirty set).
  `delta_sync` is idempotent: running it twice, or running a full
  `clone_tree` over its output, converges to the same tree.
- **move_dir_contents** — same-FS `rename` fast path (one syscall per
  top-level entry), parallel clone+delete fallback across filesystems,
  and skip-if-identical collision tolerance so a crashed partial move
  re-runs clean (reconcile's volume-migration replay).

Knobs (all also accepted as function arguments):

- ``TDAPI_COPY_MODE``: auto (default) | reflink | server | threaded | serial
- ``TDAPI_COPY_WORKERS``: copy-pool size (default min(8, cpu))
- ``TDAPI_PRECOPY``: consumed by services/replicaset.py (pre-copy on/off)

A process-global :data:`METRICS` registry accumulates bytes/seconds/mode
counts; ``/metrics`` exposes them as ``tdapi_replace_copy_*`` gauges.
"""

from __future__ import annotations

import errno
import functools
import logging
import os
import shutil
import stat as stat_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..obs import metrics as obs_metrics
from ..obs import trace

log = logging.getLogger(__name__)


def _traced(op: str):
    """Span-wrap a copy entry point: the replace trace shows WHICH copy
    stage (warm clone, delta pass, move) the time went to, with the
    resolved ladder rung and byte counts as span attrs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with trace.span(op) as sp:
                out = fn(*args, **kwargs)
                if sp is not None and isinstance(out, CopyStats):
                    sp.set(bytes=out.bytes, files=out.files, mode=out.mode,
                           deltaFiles=out.delta_files)
                return out
        return wrapper
    return deco

MODE_ENV = "TDAPI_COPY_MODE"
WORKERS_ENV = "TDAPI_COPY_WORKERS"
PRECOPY_ENV = "TDAPI_PRECOPY"

#: linux/fs.h FICLONE — share the source's extents CoW-style (btrfs, xfs
#: w/ reflink=1, bcachefs). _IOW(0x94, 9, int) on every linux arch.
FICLONE = 0x40049409

#: ladder order; "auto" starts at the top and demotes on the first rung
#: the filesystem refuses
MODES = ("reflink", "server", "threaded", "serial")

_UNSUPPORTED_ERRNOS = {
    errno.EOPNOTSUPP, errno.ENOTTY, errno.ENOSYS, errno.EXDEV,
    errno.EINVAL, errno.EBADF, getattr(errno, "ENOTSUP", errno.EOPNOTSUPP),
}


def precopy_enabled() -> bool:
    """TDAPI_PRECOPY gate (default on)."""
    return os.environ.get(PRECOPY_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


def default_workers() -> int:
    try:
        w = int(os.environ.get(WORKERS_ENV, "") or 0)
    except ValueError:
        w = 0
    return w if w > 0 else min(8, os.cpu_count() or 1)


def default_mode() -> str:
    m = os.environ.get(MODE_ENV, "").strip().lower()
    return m if m in MODES + ("auto",) else "auto"


@dataclass
class CopyStats:
    """What one clone_tree / delta_sync / move actually did."""
    bytes: int = 0
    files: int = 0
    mode: str = "auto"            # final resolved ladder rung
    seconds: float = 0.0
    delta_files: int = 0          # delta_sync only: files re-copied
    deleted: int = 0              # delta_sync only: entries removed

    def merge(self, other: "CopyStats") -> None:
        self.bytes += other.bytes
        self.files += other.files
        self.delta_files += other.delta_files
        self.deleted += other.deleted


class CopyMetrics:
    """Process-global accumulator behind the /metrics gauges."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.copy_bytes = 0
        self.copy_seconds = 0.0
        self.copies_by_mode: dict[str, int] = {}
        self.delta_files = 0
        self.last_downtime_ms = 0.0

    def observe_copy(self, stats: CopyStats) -> None:
        with self._lock:
            self.copy_bytes += stats.bytes
            self.copy_seconds += stats.seconds
            if stats.files:
                # a zero-file pass (empty delta) never exercised its
                # ladder; counting it under the initial rung would lie
                self.copies_by_mode[stats.mode] = (
                    self.copies_by_mode.get(stats.mode, 0) + 1)
            self.delta_files += stats.delta_files

    def observe_downtime(self, ms: float) -> None:
        with self._lock:
            self.last_downtime_ms = ms
        obs_metrics.REPLACE_DOWNTIME.observe(ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "copyBytes": self.copy_bytes,
                "copySeconds": round(self.copy_seconds, 6),
                "copiesByMode": dict(self.copies_by_mode),
                "deltaFiles": self.delta_files,
                "lastDowntimeMs": round(self.last_downtime_ms, 3),
            }


METRICS = CopyMetrics()


# ------------------------------------------------------------- mode ladder

class _Unsupported(Exception):
    """This rung can't copy on this filesystem pair — demote."""


def _reflink_file(src: str, dst: str) -> None:
    import fcntl
    sfd = os.open(src, os.O_RDONLY)
    try:
        dfd = os.open(dst, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            try:
                fcntl.ioctl(dfd, FICLONE, sfd)
            except OSError as e:
                raise _Unsupported(str(e)) if e.errno in _UNSUPPORTED_ERRNOS \
                    else e
        finally:
            os.close(dfd)
    finally:
        os.close(sfd)


def _server_copy_file(src: str, dst: str) -> None:
    if not hasattr(os, "copy_file_range"):
        raise _Unsupported("no os.copy_file_range")
    sfd = os.open(src, os.O_RDONLY)
    try:
        size = os.fstat(sfd).st_size
        dfd = os.open(dst, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            remaining = size
            first = True
            while remaining > 0:
                try:
                    n = os.copy_file_range(sfd, dfd, remaining)
                except OSError as e:
                    if first and e.errno in _UNSUPPORTED_ERRNOS:
                        raise _Unsupported(str(e))
                    raise
                if n == 0:          # source truncated under us: done
                    break
                remaining -= n
                first = False
        finally:
            os.close(dfd)
    finally:
        os.close(sfd)


def _copy2_file(src: str, dst: str) -> None:
    shutil.copy2(src, dst, follow_symlinks=False)


_RUNG_FN = {"reflink": _reflink_file, "server": _server_copy_file,
            "threaded": _copy2_file, "serial": _copy2_file}


class _Ladder:
    """Per-tree resolved copy rung, demoting on the first refusal.

    Shared across the copy pool's threads; the demotion race is harmless
    (both losers demote to the same next rung)."""

    def __init__(self, mode: str):
        self.rung = "reflink" if mode == "auto" else mode

    def copy_file(self, src: str, dst: str) -> None:
        while True:
            rung = self.rung
            fn = _RUNG_FN[rung]
            try:
                fn(src, dst)
            except _Unsupported as e:
                if rung not in ("reflink", "server"):
                    raise OSError(f"copy {src!r} -> {dst!r}: {e}")
                nxt = MODES[MODES.index(rung) + 1]
                log.debug("copyfast: %s unsupported (%s); demoting to %s",
                          rung, e, nxt)
                if self.rung == rung:   # racing demotions settle to the same
                    self.rung = nxt     # rung; never resurrect a dead one
                continue
            if fn is not _copy2_file:
                # reflink / copy_file_range move bytes only; carry the
                # metadata copy2 would have
                shutil.copystat(src, dst, follow_symlinks=False)
            return


# --------------------------------------------------------------- clone_tree

@_traced("copy.clone")
def clone_tree(src: str, dest: str, mode: str | None = None,
               workers: int | None = None) -> CopyStats:
    """Recursively copy ``src/*`` into ``dest`` (created if missing).

    Semantics match the seed ``copy_dir`` (utils/file.py): existing
    symlinks in dest WIN over anything in src (during rolling replacement
    the new container's bind mounts are already materialized as links and
    the new spec's binds must beat the old layer's content). On top of
    that: directory metadata is copied (``copystat``, deepest-first so a
    parent's mtime isn't re-dirtied by child writes), file copies go
    through the reflink → copy_file_range → copy2 ladder, and regular
    files are copied by a ``workers``-wide pool (sendfile/copy_file_range
    release the GIL, so the pool genuinely parallelizes).
    """
    mode = mode if mode in MODES + ("auto",) else default_mode()
    if workers is None:
        workers = default_workers()
    if mode == "serial":
        workers = 1
    ladder = _Ladder(mode)
    stats = CopyStats(mode=mode)
    t0 = time.perf_counter()
    jobs: list[tuple[str, str, int]] = []       # (src, dst, size)
    dirs: list[tuple[str, str]] = []            # (src, dst) deepest-last

    def scan(s: str, d: str) -> None:
        os.makedirs(d, exist_ok=True)
        dirs.append((s, d))
        try:
            entries = list(os.scandir(s))
        except FileNotFoundError:
            return                  # dir vanished mid-scan (live source)
        for entry in entries:
            dp = os.path.join(d, entry.name)
            if entry.is_symlink():
                if not os.path.lexists(dp):
                    try:
                        target = os.readlink(entry.path)
                    except OSError:
                        continue    # vanished mid-scan (live source)
                    os.symlink(target, dp)
            elif entry.is_dir():
                if os.path.islink(dp):
                    continue        # bind link in dest wins over a src dir
                scan(entry.path, dp)
            else:
                if os.path.lexists(dp) and os.path.islink(dp):
                    continue        # bind link in dest wins over a src file
                try:
                    st = entry.stat(follow_symlinks=False)
                except OSError:
                    continue        # vanished mid-scan (live source)
                if not stat_mod.S_ISREG(st.st_mode):
                    # FIFOs/devices/sockets: the reflink/cfr rungs would
                    # open-and-block; fail loudly like the seed's copy2
                    # (shutil.SpecialFileError) so the mutation unwinds
                    raise shutil.SpecialFileError(
                        f"`{entry.path}` is a special file (FIFO/device/"
                        f"socket) — not copyable into a container layer")
                jobs.append((entry.path, dp, st.st_size))

    scan(src, dest)

    def do_copy(job: tuple[str, str, int]) -> int:
        s, d, size = job
        try:
            ladder.copy_file(s, d)
        except FileNotFoundError:
            # unlinked between scan and copy: the whole point of the warm
            # copy is a LIVE source — skip; the delta pass (or sync purge)
            # reconciles whatever state src settles on
            return -1
        return size

    if workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="copyfast") as pool:
            for size in pool.map(do_copy, jobs):
                if size >= 0:
                    stats.bytes += size
                    stats.files += 1
    else:
        for job in jobs:
            size = do_copy(job)
            if size >= 0:
                stats.bytes += size
                stats.files += 1
    # deepest-first so copying a parent's times is not undone by children
    for s, d in reversed(dirs):
        try:
            shutil.copystat(s, d, follow_symlinks=False)
        except OSError:
            pass                    # metadata best-effort, data already safe
    stats.mode = ladder.rung
    stats.seconds = time.perf_counter() - t0
    return stats


# --------------------------------------------------- snapshot / delta sync

@dataclass
class TreeSnapshot:
    """What ``src`` looked like at pre-copy time, plus which dest entries
    predate the pre-copy (materialized bind links — never ours to touch).
    ``verified`` accumulates the files a delta pass has re-copied from a
    QUIESCENT src (the delta runs after `stop old`), so a second pass
    over the same snapshot can trust them and stay a no-op."""
    files: dict[str, tuple[int, int]] = field(default_factory=dict)
    links: dict[str, str] = field(default_factory=dict)
    dirs: set[str] = field(default_factory=set)
    dest_preexisting: set[str] = field(default_factory=set)
    verified: set[str] = field(default_factory=set)


def _scan_src(src: str):
    """Yield (relpath, kind, payload) for every entry under src.
    kind: 'file' -> (size, mtime_ns); 'link' -> target; 'dir' -> None."""
    base = src.rstrip(os.sep)
    stack = [base]
    while stack:
        cur = stack.pop()
        try:
            entries = list(os.scandir(cur))
        except FileNotFoundError:
            continue                # dir vanished mid-scan (live source)
        for entry in entries:
            rel = os.path.relpath(entry.path, base)
            if entry.is_symlink():
                try:
                    yield rel, "link", os.readlink(entry.path)
                except OSError:
                    continue        # vanished mid-scan (live source)
            elif entry.is_dir():
                yield rel, "dir", None
                stack.append(entry.path)
            else:
                try:
                    st = entry.stat(follow_symlinks=False)
                except OSError:
                    continue        # vanished mid-scan (live source)
                if not stat_mod.S_ISREG(st.st_mode):
                    raise shutil.SpecialFileError(
                        f"`{entry.path}` is a special file (FIFO/device/"
                        f"socket) — not copyable into a container layer")
                yield rel, "file", (st.st_size, st.st_mtime_ns)


@_traced("copy.snapshot")
def snapshot_tree(src: str, dest: str) -> TreeSnapshot:
    """Record src's per-file (size, mtime_ns) and dest's pre-existing
    entries. Taken BEFORE the warm copy so any write that races the copy
    shows up as a mismatch in the delta pass (the safe direction)."""
    snap = TreeSnapshot()
    for rel, kind, payload in _scan_src(src):
        if kind == "file":
            snap.files[rel] = payload
        elif kind == "link":
            snap.links[rel] = payload
        else:
            snap.dirs.add(rel)
    if os.path.isdir(dest):
        base = dest.rstrip(os.sep)
        stack = [base]
        while stack:
            cur = stack.pop()
            for entry in os.scandir(cur):
                rel = os.path.relpath(entry.path, base)
                snap.dest_preexisting.add(rel)
                if entry.is_dir() and not entry.is_symlink():
                    stack.append(entry.path)
    return snap


@_traced("copy.delta")
def delta_sync(src: str, dest: str, snap: TreeSnapshot,
               mode: str | None = None,
               workers: int | None = None) -> CopyStats:
    """Make dest match src again after a warm copy taken at ``snap`` time.

    Re-copies files created or dirtied since the snapshot (size or
    mtime_ns mismatch), recreates changed symlinks, creates new dirs, and
    deletes entries that disappeared from src in between — touching ONLY
    what the pre-copy created: entries recorded in ``snap.dest_preexisting``
    are never DELETED, pre-existing symlinks are never modified or
    descended through (symlink-wins, like the warm copy), and pre-existing
    regular files follow clone semantics (the copy may overwrite them, as
    the warm copy already did). Idempotent: a second run is a no-op, and a
    full clone_tree over the result converges to the same tree.
    """
    mode = mode if mode in MODES + ("auto",) else default_mode()
    if workers is None:
        workers = default_workers()
    if mode == "serial":
        workers = 1
    ladder = _Ladder("reflink" if mode == "auto" else mode)
    stats = CopyStats(mode=mode)
    t0 = time.perf_counter()
    base_src = src.rstrip(os.sep)
    base_dst = dest.rstrip(os.sep)
    seen_files: set[str] = set()
    seen_links: set[str] = set()
    seen_dirs: set[str] = set()
    jobs: list[tuple[str, str, int]] = []
    # src subtrees whose DEST counterpart is a bind-mount symlink (or a
    # protected pre-existing entry a type change collides with) are
    # pruned wholesale: _scan_src walks src and knows nothing of dest, so
    # without this a file under a dest-symlinked dir would be "copied"
    # THROUGH the link into the bind target. _scan_src yields every
    # ancestor dir before its children, so prefix pruning is airtight.
    pruned: list[str] = []

    for rel, kind, payload in _scan_src(base_src):
        if any(rel.startswith(p) for p in pruned):
            continue
        dp = os.path.join(base_dst, rel)
        if kind == "dir":
            seen_dirs.add(rel)
            if os.path.islink(dp):
                pruned.append(rel + os.sep)  # bind link wins whole subtree
                continue
            if not os.path.isdir(dp):
                if os.path.lexists(dp):
                    if rel in snap.dest_preexisting:
                        # a protected pre-existing file where src now has
                        # a dir: never delete it — skip the subtree
                        pruned.append(rel + os.sep)
                        continue
                    _remove_entry(dp)   # file -> dir transition since snap
                os.makedirs(dp, exist_ok=True)
            continue
        if kind == "link":
            seen_links.add(rel)
            if rel in snap.dest_preexisting:
                continue            # predates the pre-copy: not ours
            try:
                if os.readlink(dp) == payload:
                    continue        # already points where src points
            except OSError:
                pass
            if os.path.lexists(dp):
                _remove_entry(dp)
            os.makedirs(os.path.dirname(dp), exist_ok=True)
            os.symlink(payload, dp)
            stats.delta_files += 1
            continue
        seen_files.add(rel)
        if os.path.islink(dp):
            continue                # bind link in dest wins
        # a file is CLEAN only when (a) src is unchanged since the
        # pre-copy SNAPSHOT — the snapshot predates the warm copy, so a
        # same-size write landing mid-warm-copy (torn read, then copystat
        # stamps dest with the NEW mtime) still reads dirty — OR a prior
        # delta pass already re-copied it from the quiescent post-stop
        # src; AND (b) dest holds the src-stamped copy
        if snap.files.get(rel) == payload or rel in snap.verified:
            try:
                dst_st = os.lstat(dp)
                if (stat_mod.S_ISREG(dst_st.st_mode)
                        and (dst_st.st_size, dst_st.st_mtime_ns) == payload):
                    continue
            except OSError:
                pass                # missing in dest: copy it
        os.makedirs(os.path.dirname(dp), exist_ok=True)
        jobs.append((rel, dp, payload[0]))

    def do_copy(job: tuple[str, str, int]) -> int:
        rel, d, size = job
        if os.path.lexists(d) and not os.path.isfile(d):
            _remove_entry(d)        # type changed under us (dir -> file)
        try:
            ladder.copy_file(os.path.join(base_src, rel), d)
        except FileNotFoundError:
            return -1               # vanished since the delta scan
        return size

    if workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="copydelta") as pool:
            for job, size in zip(jobs, pool.map(do_copy, jobs)):
                if size < 0:
                    continue
                stats.bytes += size
                stats.files += 1
                stats.delta_files += 1
                snap.verified.add(job[0])
    else:
        for job in jobs:
            size = do_copy(job)
            if size < 0:
                continue
            stats.bytes += size
            stats.files += 1
            stats.delta_files += 1
            snap.verified.add(job[0])

    # deletions: a DEST scan drives them, not the snapshot — anything in
    # dest that src no longer has and that did not predate the pre-copy
    # was put there by the warm copy (possibly from a file src created
    # after the snapshot and deleted before the stop: snapshot-driven
    # deletion would leak exactly those ghosts into the new layer).
    # Entries in dest_preexisting (bind links et al.) are only descended
    # through, never removed; a non-pre-existing dir that src lost is
    # entirely ours (nothing pre-existing can nest under it) — rmtree.
    def purge(dcur: str, rel_prefix: str) -> None:
        for entry in os.scandir(dcur):
            rel = (os.path.join(rel_prefix, entry.name)
                   if rel_prefix else entry.name)
            if rel in snap.dest_preexisting:
                if entry.is_dir() and not entry.is_symlink():
                    purge(entry.path, rel)  # warm-copied children inside
                continue
            if entry.is_symlink():
                if rel not in seen_links:
                    _remove_entry(entry.path)
                    stats.deleted += 1
                continue
            if entry.is_dir():
                if rel in seen_dirs:
                    purge(entry.path, rel)
                else:
                    _remove_entry(entry.path)
                    stats.deleted += 1
                continue
            if rel not in seen_files:
                _remove_entry(entry.path)
                stats.deleted += 1

    purge(base_dst, "")
    stats.mode = ladder.rung
    stats.seconds = time.perf_counter() - t0
    return stats


def sync_tree(src: str, dest: str, mode: str | None = None,
              workers: int | None = None) -> CopyStats:
    """clone_tree + delete: after the copy, dest entries with NO src
    counterpart at all are removed — except symlinks (bind-mount
    materializations are sacred, so symlink-wins extends to the delete
    half), and dirs are only rmdir'd once emptied so a protected link
    keeps its parents. This is the exact-sync used for container-layer
    carries without a pre-copy snapshot (TDAPI_PRECOPY=0 and the crash
    reconciler's replay over a possibly warm-copied dest): leftovers from
    an interrupted pre-copy — files the old container deleted since —
    cannot survive into the new layer."""
    stats = clone_tree(src, dest, mode=mode, workers=workers)
    t0 = time.perf_counter()
    stats.deleted += _purge_unmatched(src.rstrip(os.sep),
                                      dest.rstrip(os.sep))
    stats.seconds += time.perf_counter() - t0
    return stats


def _purge_unmatched(src: str, dest: str) -> int:
    deleted = 0
    for entry in os.scandir(dest):
        if entry.is_symlink():
            continue                # bind materializations are sacred
        sp = os.path.join(src, entry.name)
        if entry.is_dir():
            deleted += _purge_unmatched(sp, entry.path)
            if not os.path.lexists(sp):
                try:
                    os.rmdir(entry.path)   # only if emptied: a surviving
                    deleted += 1           # symlink keeps its parents
                except OSError:
                    pass
        elif not os.path.lexists(sp):
            try:
                os.unlink(entry.path)
                deleted += 1
            except OSError:
                pass
    return deleted


def _remove_entry(path: str) -> None:
    try:
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.unlink(path)
    except OSError:
        pass


# ----------------------------------------------------- move_dir_contents

@_traced("copy.move")
def move_dir_contents(src: str, dest: str,
                      workers: int | None = None) -> CopyStats:
    """Move ``src/*`` into ``dest`` (volume scale / reconcile migration).

    Same-FS: one ``rename`` syscall per top-level entry — O(entries), not
    O(bytes). Cross-FS (EXDEV): parallel ``clone_tree`` + delete. A name
    collision (a previous partial move that crashed mid-way) is resolved
    instead of raised: identical files (size + mtime_ns) are skipped and
    the src copy dropped, differing files are re-moved over the dest copy
    (the src side is the authority — dest holds at best a stale partial),
    and directory collisions merge recursively. Idempotent under re-run.
    """
    if workers is None:
        workers = default_workers()
    stats = CopyStats(mode="rename")
    t0 = time.perf_counter()
    _move_contents(src, dest, workers, stats)
    stats.seconds = time.perf_counter() - t0
    # volume migrations count toward the same data-movement gauges the
    # layer copies feed (/metrics documents them as layer/volume moves)
    METRICS.observe_copy(stats)
    return stats


def _identical_files(a: str, b: str) -> bool:
    try:
        sa = os.lstat(a)
        sb = os.lstat(b)
    except OSError:
        return False
    if stat_mod.S_IFMT(sa.st_mode) != stat_mod.S_IFMT(sb.st_mode):
        return False
    if stat_mod.S_ISLNK(sa.st_mode):
        try:
            return os.readlink(a) == os.readlink(b)
        except OSError:
            return False
    return (sa.st_size, sa.st_mtime_ns) == (sb.st_size, sb.st_mtime_ns)


def _move_contents(src: str, dest: str, workers: int,
                   stats: CopyStats) -> None:
    os.makedirs(dest, exist_ok=True)
    for entry in os.scandir(src):
        d = os.path.join(dest, entry.name)
        if os.path.lexists(d):
            if entry.is_dir() and not entry.is_symlink() \
                    and os.path.isdir(d) and not os.path.islink(d):
                _move_contents(entry.path, d, workers, stats)
                try:
                    os.rmdir(entry.path)
                except OSError:
                    pass
                continue
            if _identical_files(entry.path, d):
                # already moved by the crashed run: drop the src copy
                _remove_entry(entry.path)
                stats.files += 1
                continue
            _remove_entry(d)        # stale partial from the crashed run
        try:
            os.rename(entry.path, d)
            stats.files += 1
            continue
        except OSError as e:
            if e.errno != errno.EXDEV:
                raise
        # cross-filesystem: copy (parallel for dirs) then delete source.
        # the stats mode flips from "rename" to the rung that moved the
        # bytes — an operator debugging a slow migration must not read
        # "rename" (O(entries)) on a copy that moved gigabytes
        if entry.is_dir() and not entry.is_symlink():
            sub = clone_tree(entry.path, d, workers=workers)
            stats.merge(sub)
            stats.mode = sub.mode
            shutil.rmtree(entry.path, ignore_errors=True)
        elif entry.is_symlink():
            os.symlink(os.readlink(entry.path), d)
            os.unlink(entry.path)
            stats.files += 1
        else:
            try:
                size = entry.stat(follow_symlinks=False).st_size
            except OSError:
                size = 0
            shutil.copy2(entry.path, d, follow_symlinks=False)
            os.unlink(entry.path)
            stats.files += 1
            stats.bytes += size
            if stats.mode == "rename":
                stats.mode = "serial"
