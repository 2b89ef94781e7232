"""Twin runs of the JAX fleet, durability and placement tests: one case,
both packages.

The cases of tests/test_federation.py, test_durability.py,
test_placement.py, test_native.py, test_engine_parity.py and
test_tdcheck.py drive the fleet's arbiter, members, ring and watch hub,
the standby replicator, the placement model and the defragmenter, the
store engines and the tdcheck models directly as often as through an App.
Each selected case runs on the JAX variant of its module and then on the
port's (tests/torch_app_twins.py loads them: every `gpu_docker_api_tpu`
import is the port's in the torch variant; `tools.tdcheck`'s models and
instrument are the port-bound copies of tests/torch_tdcheck.py), and each
variant's JAX assertions hold. Besides what torch_app_twins records of an
App (every envelope, reconcile report and stored record), each variant
records what the case's own thread sees of:

- the arbiter: every join, renew, leave, acquire and release (the reply,
  or the LeaseError's reason and owner), every read of the lease and grant
  tables (members with their epochs, grants with their holders, epochs
  and revisions);
- the ring: each owner_of answer for its key and members;
- the members: each heartbeat's adopted list, each ensure_owned grant;
- the standby replicator: each applied event's outcome, each resync's
  revision, each describe() (horizon, peer head, counters);
- placement: each candidates_for list, profile_for, snapshot and
  describe, and each place decision (pool and cards);
- the defragmenter: each diagnose, plan_eviction and run_for report;
- the tdcheck sweeps: each sweep's statistics (schedules, killed runs,
  the digest of the explored schedules).

Calls made on other threads (a member's heartbeat loop, a replicator's
tail, a daemon's request threads) are not recorded: how often they run is
the host's pace. The two records, normalised as torch_app_twins normalises
(ids, host ports, clocks, the card names) and by `names` (the generations
and types a case's fleet is built of), must be equal. The mode of a case
says how:

- "exact": as multisets;
- "set": as sets, for a case that polls until a condition holds;
- "codes": the coarse outcomes alone (envelope codes, the error classes),
  for a case whose observations depend on threads' or processes' timing
  (a SIGKILLed daemon, a lease expiring on the wall clock), less the
  fleet's heartbeat requests (a member's renewals and its reads of the
  grant and member tables, as many as its heartbeats before the kill).
  Its JAX assertions still hold on both variants.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import re
import threading

import torch_app_twins as tw
import torch_tdcheck  # noqa: F401 — registers the port-bound tdcheck

#: clock-valued keys of the fleet's records (beyond torch_app_twins's)
CLOCK_KEYS = frozenset({"lastRunMs",
                        "elapsedMs", "durationMs", "quiesceMs",
                        "downtimeMs"})

#: the observation points: (module under the package, attribute path,
#: record kind); a classmethod is wrapped as one
POINTS = (
    ("federation", "FleetArbiter.join", "arbiter.join"),
    ("federation", "FleetArbiter.renew", "arbiter.renew"),
    ("federation", "FleetArbiter.leave", "arbiter.leave"),
    ("federation", "FleetArbiter.acquire", "arbiter.acquire"),
    ("federation", "FleetArbiter.release", "arbiter.release"),
    ("federation", "FleetArbiter.members", "arbiter.members"),
    ("federation", "FleetArbiter.grants", "arbiter.grants"),
    ("federation", "HashRing.owner_of", "ring.owner_of"),
    ("federation", "FleetMember.heartbeat_once", "member.heartbeat"),
    ("federation", "FleetMember.ensure_owned", "member.ensure_owned"),
    ("replication", "StandbyReplicator.apply_event", "repl.apply"),
    ("replication", "StandbyReplicator.resync", "repl.resync"),
    ("replication", "StandbyReplicator.describe", "repl.describe"),
    ("placement", "FleetModel.candidates_for", "placement.candidates"),
    ("placement", "FleetModel.profile_for", "placement.profile"),
    ("placement", "FleetModel.snapshot", "placement.snapshot"),
    ("placement", "FleetModel.describe", "placement.describe"),
    ("placement", "FleetModel.place", "placement.place"),
    ("defrag", "Defragmenter.diagnose", "defrag.diagnose"),
    ("defrag", "Defragmenter.plan_eviction", "defrag.plan"),
    ("defrag", "Defragmenter.run_for", "defrag.run"),
    ("defrag", "Defragmenter.describe", "defrag.describe"),
)


#: the port's error classes read as JAX's in the torch variant's records
ERROR_NAMES = {"GpuNotEnoughError": "TpuNotEnoughError",
               "GpuOversubscribedError": "TpuOversubscribedError"}


class Observer:
    """The fleet-plane record of one variant's run."""

    def __init__(self, pkg: str, root: str, mode: str, names: dict):
        self.norm = tw.Norm(pkg, root)
        self.mode = mode
        self.names = dict(ERROR_NAMES, **names) if pkg == "torch" else {}
        self.rows: list = []
        self.lock = threading.Lock()
        self.thread = threading.current_thread()

    def clean(self, x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            x = dataclasses.asdict(x)
        elif isinstance(x, tuple) and hasattr(x, "_asdict"):
            x = x._asdict()
        if isinstance(x, dict):
            return {self.names.get(k, k) if isinstance(k, str) else k:
                    self.clean(v) for k, v in x.items()
                    if k not in CLOCK_KEYS}
        if isinstance(x, (list, tuple, set, frozenset)):
            out = [self.clean(v) for v in x]
            return sorted(out, key=repr) if isinstance(
                x, (set, frozenset)) else out
        if isinstance(x, str):
            return self.names.get(x, x)
        return x

    def add(self, kind: str, value, raised: bool = False) -> None:
        if threading.current_thread() is not self.thread:
            return
        if self.mode == "codes" and not raised:
            return
        row = {kind: self.norm(self.clean(value))}
        with self.lock:
            self.rows.append(row)


def _record(obs: Observer, kind: str, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            reason = getattr(e, "reason", None)
            obs.add(kind, {"raised": type(e).__name__, "reason": reason,
                           "owner": getattr(e, "owner", None)}
                    if reason is not None else
                    {"raised": type(e).__name__}, raised=True)
            raise
        obs.add(kind, {"args": [a for a in args[1:]
                                if isinstance(a, (str, int, float))],
                       "out": out})
        return out
    return wrapped


def _sweep_stats(obs: Observer, fn):
    @functools.wraps(fn)
    def wrapped(stats):
        out = fn(stats)
        obs.add("sweep", {k: out.get(k) for k in (
            "model", "schedules", "killed_runs", "digest")})
        return out
    return wrapped


def _pkg_mod(pkg: str, name: str):
    root = "gpu_docker_api_tpu" if pkg == "jax" else "gpu_docker_api_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def install(obs: Observer, pkg: str, points) -> list:
    """Wrap the observation points of `pkg`; returns the undo list."""
    undo = []
    # a case that imports make_topology in its body gets the line of
    # cards of the same size, as the module's own name does
    topo = _pkg_mod(pkg, "topology")
    undo.append((topo, "make_topology", topo.make_topology))
    topo.make_topology = tw._make_topology(pkg)
    for mod_name, path, kind in points:
        if pkg == "torch":
            path = tw.port_names(path)
        owner = _pkg_mod(pkg, mod_name)
        *outer, attr = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        raw = owner.__dict__[attr]
        undo.append((owner, attr, raw))
        if isinstance(raw, classmethod):
            # the class is the first argument, kept out of the record
            setattr(owner, attr, classmethod(
                _record(obs, kind, raw.__func__)))
        else:
            setattr(owner, attr, _record(obs, kind, raw))
    models = (importlib.import_module("tools.tdcheck.models") if pkg == "jax"
              else torch_tdcheck.models)
    undo.append((models, "_seal", models._seal))
    models._seal = _sweep_stats(obs, models._seal)
    return undo


def uninstall(undo: list) -> None:
    for owner, attr, old in reversed(undo):
        setattr(owner, attr, old)


def run(mod, pkg, fn_name, tmp_path, params, mode, names, points,
        setup=None):
    root = str(tmp_path / pkg)
    obs = Observer(pkg, root, mode, names)
    undo = install(obs, pkg, points)
    mp = None
    try:
        if setup is not None:
            import pytest
            mp = pytest.MonkeyPatch()
            setup(pkg, mod, mp)
        rows = tw.run_variant(mod, pkg, fn_name, tmp_path, params,
                              codes_only=mode == "codes")
    finally:
        if mp is not None:
            mp.undo()
        uninstall(undo)
    return [{"app": obs.clean(r)} for r in rows] + obs.rows


#: a member heartbeat's requests to its arbiter host
HEARTBEAT = re.compile(r"^(POST /api/v1/fleet/lease/[^/]+/renew|"
                       r"GET /api/v1/fleet/(grants|members))$")


def _as_set(rows):
    out, seen = [], set()
    for r in rows:
        k = tw._key(r)
        if k not in seen:
            seen.add(k)
            out.append(r)
    return out


def twin(name, fn_name, tmp_path, params=None, patches=(), mode="exact",
         extra="", names=None, points=POINTS, setup=None, renames=()):
    """One case on both variants. `setup(pkg, module, monkeypatch)`, when
    given, runs before each variant's case (a test-only table, say);
    `renames` are torch_app_twins.load_variant's."""
    params = params or {}
    rows = {}
    for pkg in ("jax", "torch"):
        mod = tw.load_variant(name, pkg, patches, extra, renames)
        rows[pkg] = run(mod, pkg, fn_name, tmp_path, params, mode,
                        names or {}, points, setup)
    jrows, trows = rows["jax"], rows["torch"]
    if mode == "codes":
        jrows, trows = ([r for r in rs if not HEARTBEAT.match(
            r.get("app", {}).get("req", ""))] for rs in (jrows, trows))
    if mode != "exact":
        jrows, trows = _as_set(jrows), _as_set(trows)
    tw.assert_same(jrows, trows)


def twin_tests(name, select=None, patches=(), modes=None, extra="",
               names=None, setup=None, sweeps=(), renames=(),
               exclude=(), points=POINTS) -> dict:
    """{test name: test} for each test function of tests/<name>.py (or
    those in `select`) but those in `exclude`, each a twin run in its
    mode (`modes`: name ->
    mode, default "exact") with `points` observed (JAX's class names,
    read as the port's in the torch variant); the cases in `sweeps` drive
    the tdcheck models, whose thousands of schedules are recorded as each
    sweep's statistics alone. Marks are carried over."""
    modes = modes or {}

    def runner(fn_name, tmp_path, params):
        twin(name, fn_name, tmp_path, params, patches,
             modes.get(fn_name, "exact"), extra, names,
             () if fn_name in sweeps else points, setup, renames)
    return tw.twin_tests(name, select=select, patches=patches, extra=extra,
                         runner=runner, exclude=exclude)
