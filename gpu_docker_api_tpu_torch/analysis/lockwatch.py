"""lockwatch — dynamic lock-order and lock-across-I/O watcher.

The port's copy of the JAX control plane's analysis/lockwatch.py,
unchanged: it watches the locks created inside this package.

The direct analog of the Go race detector this Python rebuild never had:
with TDAPI_LOCKWATCH=1, every `threading.Lock()` / `RLock()` /
`Condition()` created *inside the control-plane package* is replaced by a
thin wrapper that records, per thread, which locks are held when another
is acquired. From those observations it maintains:

- the **lock-order graph**: a directed edge A -> B for every "acquired B
  while holding A" ever observed, keyed by the locks' *creation site*
  (file:line), with one example acquisition stack per edge. A cycle in
  this graph is a potential deadlock (two threads interleaving the two
  orders wedge forever) even if the run itself never deadlocked — that is
  the point: the whole tier-1 suite doubles as a race sweep.
- **held-across-backend findings**: GuardedBackend reports every op entry
  (`note_backend_op`); if the calling thread holds any watched lock at
  that moment, the (lock site, op) pair is recorded. Holding a hot lock
  across substrate I/O serializes every other writer behind dockerd.
  Per-name mutation mutexes are allowlisted by design (their whole job is
  to serialize one container's multi-step mutation, backend calls
  included): a lock created inside a function named in IO_EXEMPT_FUNCS is
  exempt, as is anything passed to `exempt_io()`.

Granularity is the creation site, not the instance: two schedulers built
from the same line share a node. Consequently same-site edges are skipped
(indistinguishable from reentrant acquisition at this granularity), so
ABBA between two *peer instances* of one class is out of scope — the
static layer's discipline (never call peer methods while holding your own
lock) covers that.

Overhead is kept test-suite friendly: acquisition fast path is a few
thread-local list ops; a stack is captured only the first time a given
edge or finding appears.

Use:
    lockwatch.install()            # patches threading.* factories
    ... run anything ...
    lockwatch.report()             # dict: edges, cycles, findings
    lockwatch.assert_clean()       # raises AssertionError on cycles/IO
    lockwatch.uninstall()

`install()` is idempotent; the JAX package's tests/conftest.py calls its
own copy at import when TDAPI_LOCKWATCH=1, and a caller of this copy
installs it before importing the modules whose locks it watches. At
process exit an armed watcher prints its report to stderr (and writes
JSON to $TDAPI_LOCKWATCH_REPORT when set).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import traceback
from typing import Optional

__all__ = [
    "LockWatcher", "install", "uninstall", "installed", "watcher",
    "note_backend_op", "exempt_io", "report", "assert_clean", "reset",
]

# originals, bound before any patching
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)

#: locks created inside a function with one of these names are held across
#: backend ops BY DESIGN (per-name mutation mutexes: services/replicaset.py
#: + services/volume.py `_mutex`) — exempt from held-across-backend findings
IO_EXEMPT_FUNCS = frozenset({"_mutex"})

#: path fragments excluded from watching even inside the package (workload
#: runtimes have their own locking discipline and huge acquire volumes)
_EXCLUDED_FRAGMENTS = (os.sep + "workloads" + os.sep,)


def _creation_site() -> tuple[Optional[str], bool]:
    """(site, io_exempt) for the frame that called a lock factory: the
    repo-relative file:line, or (None, False) when the caller is outside
    the watched package (stdlib, tests, torch, ...)."""
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _SELF:
        f = f.f_back
    if f is None:
        return None, False
    ap = os.path.abspath(f.f_code.co_filename)
    if not ap.startswith(_PKG_DIR + os.sep):
        return None, False
    if any(frag in ap for frag in _EXCLUDED_FRAGMENTS):
        return None, False
    rel = os.path.relpath(ap, os.path.dirname(_PKG_DIR)).replace(os.sep, "/")
    return f"{rel}:{f.f_lineno}", f.f_code.co_name in IO_EXEMPT_FUNCS


def _stack_summary(limit: int = 12) -> str:
    """Compact acquisition stack: repo frames only, innermost last."""
    out = []
    for fr in traceback.extract_stack()[:-2]:
        ap = os.path.abspath(fr.filename)
        if not ap.startswith(os.path.dirname(_PKG_DIR)):
            continue
        rel = os.path.relpath(
            ap, os.path.dirname(_PKG_DIR)).replace(os.sep, "/")
        out.append(f"{rel}:{fr.lineno}:{fr.name}")
    return " <- ".join(reversed(out[-limit:]))


class LockWatcher:
    """All observation state. The module-level `install()` wires one
    global instance into `threading.*`; tests may instantiate their own
    and build watched locks directly via make_lock()/make_rlock()/
    make_condition() without touching global state."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()          # guards first-sighting inserts only
        self._local = threading.local()  # .held: [[lock_id, site, exempt]]
        self.edges: dict[tuple, int] = {}        # (a_site, b_site) -> count
        self.edge_stacks: dict[tuple, str] = {}  # first sighting stack
        self.io_findings: dict[tuple, str] = {}  # (site, op) -> stack
        self.sites: dict[str, int] = {}          # site -> locks created
        self.acquires = 0                        # fast-path counter (racy)
        self.exempt_sites: set[str] = set()

    # ---- factories --------------------------------------------------

    def make_lock(self, site: Optional[str] = None, exempt: bool = False):
        return _WatchedLock(self, _REAL_LOCK(), site or "<anon>", exempt)

    def make_rlock(self, site: Optional[str] = None, exempt: bool = False):
        return _WatchedLock(self, _REAL_RLOCK(), site or "<anon>", exempt)

    def make_condition(self, lock=None, site: Optional[str] = None,
                       exempt: bool = False):
        return _WatchedCondition(self, lock, site or "<anon>", exempt)

    # ---- per-thread held stack --------------------------------------

    def _held(self) -> list:
        try:
            return self._local.held
        except AttributeError:
            held = self._local.held = []
            return held

    def _pre_acquire(self, lock) -> None:
        """Record lock-order edges for an acquisition ATTEMPT (the order
        violation exists whether or not this particular attempt blocks)."""
        held = self._held()
        if not held:
            return
        lid, site = id(lock), lock._site
        for hid, hsite, _ex in held:
            if hid == lid or hsite == site:
                # reentrant (RLock) or peer-instance same-site: no edge —
                # see the granularity note in the module docstring
                continue
            key = (hsite, site)
            n = self.edges.get(key)
            if n is None:
                with self._mu:
                    if key not in self.edges:
                        self.edges[key] = 0
                        self.edge_stacks[key] = _stack_summary()
            self.edges[key] = self.edges.get(key, 0) + 1

    def _push(self, lock) -> None:
        self.acquires += 1
        self._held().append((id(lock), lock._site,
                             lock._exempt or lock._site in self.exempt_sites))

    def _pop(self, lock) -> None:
        held = self._held()
        lid = id(lock)
        # locks may legally be released out of LIFO order: drop the most
        # recent entry for THIS lock
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lid:
                del held[i]
                return

    # ---- observations ------------------------------------------------

    def note_lock_created(self, site: str) -> None:
        with self._mu:
            self.sites[site] = self.sites.get(site, 0) + 1

    def note_backend_op(self, op: str) -> None:
        """Called by GuardedBackend at op entry, on the CALLER's thread
        (the deadline worker thread holds nothing)."""
        held = getattr(self._local, "held", None)
        if not held:
            return
        for _lid, site, exempt in held:
            if exempt or site in self.exempt_sites:
                continue
            key = (site, op)
            if key not in self.io_findings:
                with self._mu:
                    self.io_findings.setdefault(key, _stack_summary())

    def exempt_io(self, lock_or_site) -> None:
        """Allowlist a watched lock (or a creation site) from
        held-across-backend findings — use for locks whose design holds
        them across substrate calls, with a comment saying why."""
        site = (lock_or_site if isinstance(lock_or_site, str)
                else lock_or_site._site)
        with self._mu:
            self.exempt_sites.add(site)

    # ---- analysis ----------------------------------------------------

    def _snapshot(self) -> tuple[dict, dict, dict, dict]:
        """Locked copies of the observation maps: report() may run (atexit,
        session sweep) while daemon/background threads still acquire — a
        first-sighting insert mid-iteration would crash the race
        detector's own report."""
        with self._mu:
            return (dict(self.edges), dict(self.edge_stacks),
                    dict(self.io_findings), dict(self.sites))

    def cycles(self) -> list[list[str]]:
        """Cycles in the lock-order graph, as site lists (each a strongly
        connected component with >= 2 nodes; same-site self-loops cannot
        occur — _pre_acquire skips them). Tarjan, iterative."""
        edges, _, _, _ = self._snapshot()
        graph: dict[str, list[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        for root in graph:
            if root in index:
                continue
            work = [(root, iter(graph[root]))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(graph[nxt])))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        return sorted(sccs)

    def report(self) -> dict:
        edges, edge_stacks, io_findings, sites = self._snapshot()
        cyc = self.cycles()
        cycle_edges = []
        for comp in cyc:
            comp_set = set(comp)
            for (a, b), stack in sorted(edge_stacks.items()):
                if a in comp_set and b in comp_set:
                    cycle_edges.append(
                        {"from": a, "to": b, "count": edges.get((a, b), 0),
                         "stack": stack})
        return {
            "lockSites": dict(sorted(sites.items())),
            "acquires": self.acquires,
            "edges": [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(edges.items())],
            "cycles": [{"sites": comp} for comp in cyc],
            "cycleEdges": cycle_edges,
            "heldAcrossBackend": [
                {"lock": site, "op": op, "stack": stack}
                for (site, op), stack in sorted(io_findings.items())],
            "exemptSites": sorted(self.exempt_sites),
        }

    def assert_clean(self) -> None:
        rep = self.report()
        problems = []
        for c in rep["cycles"]:
            problems.append(
                f"lock-order cycle (potential deadlock): "
                f"{' <-> '.join(c['sites'])}")
        for e in rep["cycleEdges"]:
            problems.append(
                f"  edge {e['from']} -> {e['to']} (x{e['count']}) "
                f"at {e['stack']}")
        for f in rep["heldAcrossBackend"]:
            problems.append(
                f"lock {f['lock']} held across backend op '{f['op']}' "
                f"at {f['stack']}")
        if problems:
            raise AssertionError(
                "lockwatch found concurrency hazards:\n  "
                + "\n  ".join(problems))


class _WatchedLock:
    """Drop-in threading.Lock/RLock wrapper. Only the methods the stdlib
    contract defines; anything exotic falls through to the inner lock."""

    __slots__ = ("_watcher", "_inner", "_site", "_exempt")

    def __init__(self, watcher: LockWatcher, inner, site: str,
                 exempt: bool) -> None:
        self._watcher = watcher
        self._inner = inner
        self._site = site
        self._exempt = exempt
        watcher.note_lock_created(site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._watcher._pre_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._watcher._push(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._watcher._pop(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # noqa: D105
        return f"<watched {self._inner!r} site={self._site}>"


class _WatchedCondition:
    """threading.Condition wrapper. wait()/wait_for() delegate whole: the
    release-reacquire window lives entirely inside the blocking call, so
    this thread can neither acquire nor enter a backend op during it —
    the held stack never tells a lie anyone reads."""

    __slots__ = ("_watcher", "_inner", "_site", "_exempt")

    def __init__(self, watcher: LockWatcher, lock, site: str,
                 exempt: bool) -> None:
        self._watcher = watcher
        if lock is None:
            inner_lock = _REAL_RLOCK()
        elif isinstance(lock, _WatchedLock):
            inner_lock = lock._inner     # share the caller's real lock
        else:
            inner_lock = lock
        self._inner = _REAL_CONDITION(inner_lock)
        self._site = site
        self._exempt = exempt
        watcher.note_lock_created(site)

    def acquire(self, *args) -> bool:
        self._watcher._pre_acquire(self)
        got = self._inner.acquire(*args)
        if got:
            self._watcher._push(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._watcher._pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __repr__(self) -> str:  # noqa: D105
        return f"<watched {self._inner!r} site={self._site}>"


# ------------------------------------------------------------- global wiring

_watcher: Optional[LockWatcher] = None
_atexit_registered = False


def installed() -> bool:
    return _watcher is not None


def watcher() -> Optional[LockWatcher]:
    return _watcher


def _lock_factory():
    site, exempt = _creation_site()
    if _watcher is None or site is None:
        return _REAL_LOCK()
    return _WatchedLock(_watcher, _REAL_LOCK(), site, exempt)


def _rlock_factory():
    site, exempt = _creation_site()
    if _watcher is None or site is None:
        return _REAL_RLOCK()
    return _WatchedLock(_watcher, _REAL_RLOCK(), site, exempt)


def _condition_factory(lock=None):
    site, exempt = _creation_site()
    if _watcher is None or site is None:
        if isinstance(lock, _WatchedLock):
            # out-of-scope Condition over a watched lock (stdlib helper
            # handed one of ours): bind to the real inner lock
            return _REAL_CONDITION(lock._inner)
        return _REAL_CONDITION(lock)
    return _WatchedCondition(_watcher, lock, site, exempt)


def install(report_at_exit: bool = False) -> LockWatcher:
    """Patch threading.Lock/RLock/Condition so control-plane lock creation
    is watched. Idempotent; returns the active watcher."""
    global _watcher, _atexit_registered
    if _watcher is None:
        _watcher = LockWatcher()
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
        threading.Condition = _condition_factory
    if report_at_exit and not _atexit_registered:
        _atexit_registered = True
        atexit.register(_exit_report)
    return _watcher


def uninstall() -> None:
    """Restore the real factories. Already-created watched locks keep
    working (they wrap real primitives); they just stop being counted."""
    global _watcher
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _watcher = None


def reset() -> None:
    """Drop observations, keep the installation and exemptions (fresh
    graph per phase). Clears IN PLACE: every already-created watched lock
    holds a reference to its watcher, so swapping the global for a fresh
    instance would orphan them — their edges would land in a graph nobody
    reports. Per-thread held stacks survive untouched (locks currently
    held must keep their entries or their releases would underflow)."""
    w = _watcher
    if w is not None:
        with w._mu:
            w.edges.clear()
            w.edge_stacks.clear()
            w.io_findings.clear()
            w.sites.clear()
            w.acquires = 0


def note_backend_op(op: str) -> None:
    """Fast no-op unless installed — called from GuardedBackend._guard."""
    w = _watcher
    if w is not None:
        w.note_backend_op(op)


def exempt_io(lock_or_site) -> None:
    w = _watcher
    if w is not None:
        w.exempt_io(lock_or_site)


def report() -> dict:
    w = _watcher
    return w.report() if w is not None else {}


def assert_clean() -> None:
    w = _watcher
    if w is not None:
        w.assert_clean()


def _exit_report() -> None:
    w = _watcher
    if w is None:
        return
    rep = w.report()
    path = os.environ.get("TDAPI_LOCKWATCH_REPORT", "")
    if path:
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(rep, f, indent=2, sort_keys=True)
        except OSError as e:  # pragma: no cover - report path is best-effort
            print(f"lockwatch: cannot write {path}: {e}", file=sys.stderr)
    ncyc, nio = len(rep["cycles"]), len(rep["heldAcrossBackend"])
    print(f"lockwatch: {len(rep['lockSites'])} lock site(s), "
          f"{rep['acquires']} acquire(s), {len(rep['edges'])} order "
          f"edge(s), {ncyc} cycle(s), {nio} held-across-backend",
          file=sys.stderr)
    for c in rep["cycles"]:
        print(f"lockwatch: CYCLE {' <-> '.join(c['sites'])}",
              file=sys.stderr)
    for f_ in rep["heldAcrossBackend"]:
        print(f"lockwatch: HELD-ACROSS-BACKEND {f_['lock']} over "
              f"'{f_['op']}' at {f_['stack']}", file=sys.stderr)
