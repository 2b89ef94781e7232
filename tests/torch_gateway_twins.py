"""Twin runs of the JAX serving control plane's tests: one case, both
packages.

The cases of tests/test_gateway.py, test_tail_tolerance.py,
test_workers.py, test_obs_mp.py and test_kv_routing.py drive a gateway, a
worker router or a worker tier directly (an injected transport, a shared
segment, real mock replicas) as often as through an App. Each selected
case runs on the JAX variant of its module and then on the port's
(tests/torch_app_twins.py loads them: every `gpu_docker_api_tpu` import is
the port's in the torch variant), and each variant's JAX assertions hold.
Besides what torch_app_twins records of an App (every envelope, reconcile
report and stored record), each variant records:

- every `Gateway.forward` and `WorkerRouter.forward`: the reply (status
  and envelope) or the error's class (a shed, a deadline, a retry-budget
  503, an injected crash);
- every event of the EventLog: op, target, code and detail;
- the tail-tolerance decisions: each distinct `eject_set` result (a
  router recomputes its eject set on a timer, so how often is the host's
  pace), each hedge token taken or refused (`HedgePolicy.take`), each
  retry granted or refused (`RetryBudget.try_retry`);
- each reply of the modules' wire helpers (`data_call` to a worker tier,
  `_post` / `_get` to a mock replica): status and envelope;
- at the end of the case, every gateway's `describe()`: the roster with
  each replica's state, in-flight and failures, and the counters. An App
  stops only once no replica of its gateways is still starting (its
  readiness probe runs on a timer), so both records see the same roster.

Calls made on a thread that was alive before the variant began (the
control loops of an earlier case's Apps, which some JAX cases leave
running) are not recorded. The two records, normalised as torch_app_twins
normalises (ids, host ports, clocks, the card names), must be equal. The mode of a case says
how:

- "exact": as multisets (each observation as often on both sides);
- "set": as sets, for a case whose body polls until a condition holds, so
  that a poll is repeated as often as the host is slow; a poll's refused
  or dropped connection (a worker not yet bound) is not recorded;
- "codes": as sets of the coarse outcomes alone (envelope and reply codes,
  the error classes, the event ops), for a case whose roster and counts
  depend on the threads' timing (an autoscaler racing a burst), as
  torch_app_twins's `races`.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json
import threading

import torch_app_twins as tw

#: the clock-valued keys of the serving plane's records (beyond
#: torch_app_twins.CLOCK_KEYS): latency digests, waits, ages; and process
#: ids, random by design
CLOCK_KEYS = frozenset({
    "pid", "pids",
    "scaleReadyMsHistory", "fleetMedianMs", "hedgeDelayMs", "p95Ms",
    "ewmaMs", "p50Ms", "p99Ms", "queueWaitMs", "lastScaleAt", "idleS",
    "lastRequestAt", "readyAt", "startedAt", "probeDueInS", "ejectedAt",
    "ageS", "uptimeS", "retryTokens", "hedgeTokens", "latencyMs",
    "serviceMs", "elapsedMs", "readyMs", "ms"})


class Observer:
    """The serving-plane record of one variant's run."""

    def __init__(self, pkg: str, root: str, mode: str):
        self.norm = tw.Norm(pkg, root)
        self.mode = mode
        self.rows: list = []
        self.lock = threading.Lock()
        self.gateways: list = []
        me = threading.current_thread()
        self.stale = {t for t in threading.enumerate() if t is not me}

    def clean(self, x):
        if isinstance(x, dict):
            return {k: self.clean(v) for k, v in x.items()
                    if k not in CLOCK_KEYS}
        if isinstance(x, (list, tuple)):
            return [self.clean(v) for v in x]
        return x

    def add(self, kind: str, value, once: bool = False) -> None:
        if threading.current_thread() in self.stale:
            return
        row = {kind: self.norm(self.clean(value))}
        with self.lock:
            if not (once and row in self.rows):
                self.rows.append(row)

    def reply(self, out):
        """A forward's or a helper's reply: status and envelope."""
        if not isinstance(out, tuple):
            return "<stream>" if inspect.isgenerator(out) else repr(out)
        status, payload = out[0], out[1]
        if inspect.isgenerator(payload) or hasattr(payload, "__next__"):
            return [status, "<stream>"]
        if isinstance(payload, (bytes, bytearray)):
            try:
                payload = json.loads(payload)
            except ValueError:
                payload = payload.decode("utf-8", "replace")
        if self.mode == "codes":
            code = payload.get("code") if isinstance(payload, dict) else None
            return [status, code]
        return [status, payload]


def _record_call(obs: Observer, kind: str, fn, shape=None, transient=(),
                 once=False):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except BaseException as e:
            if not isinstance(e, transient):
                obs.add(kind, {"raised": type(e).__name__})
            raise
        obs.add(kind, shape(out) if shape else out, once=once)
        return out
    return wrapped


def _settled(app, timeout=30.0) -> None:
    """Wait until no replica of the App's gateways is starting or
    stopping."""
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        states = [r["state"] for g in app.gateways.snapshot()
                  for r in g["replicas"]]
        if not {"starting", "stopping"} & set(states):
            return
        time.sleep(0.01)


def _pkg_mod(pkg: str, name: str):
    root = "gpu_docker_api_tpu" if pkg == "jax" else "gpu_docker_api_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def install(obs: Observer, pkg: str, mod) -> list:
    """Wrap the observation points of `pkg` and of the case's module;
    returns the undo list."""
    undo = []

    def patch(owner, attr, new):
        undo.append((owner, attr, owner.__dict__[attr]
                     if isinstance(owner, type) else getattr(owner, attr)))
        setattr(owner, attr, new)

    # a case that imports make_topology in its body gets the line of
    # cards of the same size, as the module's own name does
    patch(_pkg_mod(pkg, "topology"), "make_topology",
          tw._make_topology(pkg))
    gateway = _pkg_mod(pkg, "gateway")
    tail = _pkg_mod(pkg, "tailtolerance")
    events = _pkg_mod(pkg, "events")
    G = gateway.Gateway
    patch(G, "forward", _record_call(obs, "forward", G.forward, obs.reply))
    orig_init = G.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        with obs.lock:
            obs.gateways.append(self)
    patch(G, "__init__", functools.wraps(orig_init)(init))
    if obs.mode != "codes":
        patch(tail, "eject_set", _record_call(
            obs, "eject", tail.eject_set, lambda s: sorted(map(str, s)),
            once=True))
        patch(tail.HedgePolicy, "take", _record_call(
            obs, "hedge.take", tail.HedgePolicy.take))
        patch(tail.RetryBudget, "try_retry", _record_call(
            obs, "retry", tail.RetryBudget.try_retry))
    app_cls = _pkg_mod(pkg, "server.app").App
    orig_stop = app_cls.stop

    def stop(self):
        if getattr(self, "gateways", None) is not None:
            _settled(self)
        return orig_stop(self)
    patch(app_cls, "stop", functools.wraps(orig_stop)(stop))
    orig_record = events.EventLog.record

    def record(self, op, target="", code=200, duration_ms=0.0,
               request_id="", **extra):
        if obs.mode == "codes":
            obs.add("event", op)
        else:
            obs.add("event", {"op": op, "target": target, "code": code,
                              "detail": extra})
        return orig_record(self, op, target, code, duration_ms,
                           request_id, **extra)
    patch(events.EventLog, "record", functools.wraps(orig_record)(record))
    try:
        workers = _pkg_mod(pkg, "server.workers")
    except ImportError:
        workers = None
    if workers is not None:
        W = workers.WorkerRouter
        patch(W, "forward", _record_call(obs, "worker.forward", W.forward,
                                         obs.reply))
    for name in ("data_call", "_post", "_get"):
        fn = getattr(mod, name, None)
        if callable(fn):
            patch(mod, name, _record_call(
                obs, name, fn, lambda out: obs.reply((out[0], out[2])),
                transient=OSError if obs.mode == "set" else ()))
    return undo


def uninstall(undo: list) -> None:
    for owner, attr, old in reversed(undo):
        setattr(owner, attr, old)


def _settle(obs: Observer) -> None:
    if obs.mode == "codes":
        return
    for gw in obs.gateways:
        try:
            d = gw.describe()
        except Exception as e:  # noqa: BLE001 — the record says so
            d = {"describe": type(e).__name__}
        obs.add("describe", d)


def run(mod, pkg, fn_name, tmp_path, params, mode):
    root = str(tmp_path / pkg)
    obs = Observer(pkg, root, mode)
    undo = install(obs, pkg, mod)
    try:
        rows = tw.run_variant(mod, pkg, fn_name, tmp_path, params,
                              codes_only=mode == "codes")
        _settle(obs)
    finally:
        uninstall(undo)
    return rows + obs.rows


def _as_set(rows):
    out, seen = [], set()
    for r in rows:
        k = tw._key(r)
        if k not in seen:
            seen.add(k)
            out.append(r)
    return out


def twin(name, fn_name, tmp_path, params=None, patches=(), mode="exact",
         extra=""):
    params = params or {}
    jmod = tw.load_variant(name, "jax", patches, extra)
    tmod = tw.load_variant(name, "torch", patches, extra)
    jrows = run(jmod, "jax", fn_name, tmp_path, params, mode)
    trows = run(tmod, "torch", fn_name, tmp_path, params, mode)
    if mode != "exact":
        jrows, trows = _as_set(jrows), _as_set(trows)
    tw.assert_same(jrows, trows)


def twin_tests(name, select, patches=(), modes=None, extra="") -> dict:
    """{test name: test} for each test function of tests/<name>.py in
    `select`, each a twin run in its mode (`modes`: name -> mode, default
    "exact"); marks are carried over (torch_app_twins.twin_tests)."""
    modes = modes or {}

    def runner(fn_name, tmp_path, params):
        twin(name, fn_name, tmp_path, params, patches,
             modes.get(fn_name, "exact"), extra)
    return tw.twin_tests(name, select=select, patches=patches, extra=extra,
                         runner=runner)
