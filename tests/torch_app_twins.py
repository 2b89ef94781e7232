"""Twin runs of the JAX daemon's tests: one case, both Apps.

`load_variant(name, pkg)` executes the source of `tests/<name>.py` as a
module bound to one package: "jax" keeps its imports, "torch" reads every
`gpu_docker_api_tpu` import as the port's `gpu_docker_api_tpu_torch` (and
JAX's TPU class names as the port's card names). In both variants every
accelerator type the test names is a line of as many cards as the type has
chips (v4-32 -> h100-16, v4-16 -> h100-8, v4-8 and v5p-8 -> h100-4), one
node, built the
way tests/test_torch_services.py builds it: JAX's
TpuTopology("h100-N", "h100", (N, 1, 1)) and the port's GpuTopology of the
same shape.

`twin_tests(name, ...)` turns each selected test function of that module
into one test that runs the case on the JAX variant and then on the port's,
each under its own tmp_path subdirectory, its own fixtures (the module's
own, resolved here, autouse ones included) and its own mock backend. Each
case's JAX assertions hold on both. Every envelope a server answers
(ApiServer._handle), every Response the module's `direct()` helper gets,
every reconcile report (with the store's records after it), and every
App's stored records at stop() are recorded; the two records,
normalised, must be equal as multisets (threads in a case may answer in
either order).

What is normalised, and nothing else:
- random by design: request, trace and span ids (and any 16- or 32-hex
  token in a string), image ids, host port numbers (a loopback address's
  port in a string too), and wall-clock values
  (timestamps, durations, retention counters of ms-timed traces);
- each variant's own directory reads as <root>;
- JAX's card mapping: TPU_VISIBLE_CHIPS is CUDA_VISIBLE_DEVICES (with
  CUDA_DEVICE_ORDER=PCI_BUS_ID, without the libtpu-only variables),
  /dev/accel<i> is /dev/nvidia<i>, chip id tpu-<i> is gpu-<i>, and JAX's
  compile-cache bind and env are dropped (the port injects none:
  tests/test_torch_services.py::test_no_compile_cache_is_injected);
- /metrics is recorded as its sample names and labels, with values for the
  inventory families only (latency histograms are wall-clock);
- a list of trace summaries (GET /traces answers them slowest first, an
  order of wall-clock durations) is recorded in a canonical order.
"""

from __future__ import annotations

import collections
import functools
import inspect
import json
import os
import pathlib
import re
import sys
import types

import pytest

from gpu_docker_api_tpu import topology as jtopo
from gpu_docker_api_tpu.server import http as jhttp
from gpu_docker_api_tpu.server.app import App as JApp
from gpu_docker_api_tpu_torch import topology as ttopo
from gpu_docker_api_tpu_torch.server import http as thttp
from gpu_docker_api_tpu_torch.server.app import App as TApp
from gpu_docker_api_tpu.reconcile import Reconciler as JReconciler
from gpu_docker_api_tpu_torch.reconcile import Reconciler as TReconciler
from test_torch_topology import card_env_of

TESTS = os.path.dirname(os.path.abspath(__file__))

#: chips of each accelerator type the twinned tests name
TYPE_CHIPS = {"v4-32": 16, "v4-16": 8, "v4-8": 4, "v5p-8": 4}

#: JAX test-source names -> the port's, in the torch variant
PORT_NAMES = (
    (r"\bgpu_docker_api_tpu\b(?!_torch)", "gpu_docker_api_tpu_torch"),
    (r"\bTpuScheduler\b", "GpuScheduler"),
    (r"\bparse_tpu_count\b", "parse_gpu_count"),
    (r"\bTpuTopology\b", "GpuTopology"),
    (r"\bTpu(NotEnough|Oversubscribed)Error\b", r"Gpu\1Error"),
    (r"\bsched\.tpu\.", "sched.gpu."),
)

CLOCK_KEYS = frozenset({
    "createTime", "ts", "durationMs", "downtimeMs", "copySeconds", "at",
    "start", "t", "startedAt", "lastProbeAt", "expiresAt", "lastRunMs",
    "busySeconds", "waitSeconds", "windowMs", "seconds", "uptimeS",
    "firstRetained", "lastEventId", "seq", "lastSeq", "begunAt",
    "spanCount", "spansTotal", "ttlRemaining"})
ID_KEYS = frozenset({"requestId", "traceId", "spanId", "parentId"})
PORT_KEYS = frozenset({"portBindings", "port_bindings", "usedPortSet",
                       "hostPort", "port", "used"})
#: JAX's compile-cache injection, which the port does not do (a torch
#: child reads no XLA cache; tests/test_torch_services.py)
XLA_CACHE_ENV = ("JAX_COMPILATION_CACHE_DIR=",
                 "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS=",
                 "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES=")
#: /metrics families whose values are deterministic inventories
VALUED_FAMILIES = re.compile(
    r"^tdapi_(tpu_chips|cpu_cores|ports|replicasets|volumes|"
    r"workqueue_dropped|reconcile_actions|"
    r"tpu_shares_\w+|mutations_\w+|idempotency_\w+|reshards_total|"
    r"breaker_\w+|events_stream_clients|chip_health_failures)")
_HEX = re.compile(r"\b[0-9a-f]{32}\b|\b[0-9a-f]{16}\b")
_LOOPBACK_PORT = re.compile(r"\b127\.0\.0\.1:\d+\b")

#: appended to a module whose cases a patch makes wait on a condition
#: where the JAX case sleeps a fixed time for it (`_until(cond)`): both
#: variants then wait for the same state, however loaded the host
UNTIL = '''

def _until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "the condition never held"
        time.sleep(0.005)
'''


# ---------------------------------------------------------------- variants

def line(pkg: str, n: int):
    if pkg == "jax":
        return jtopo.TpuTopology(f"h100-{n}", "h100", (n, 1, 1),
                                 chips_per_host=n, num_workers=1)
    return ttopo.GpuTopology(f"h100-{n}", "h100", (n, 1, 1),
                             chips_per_host=n, num_workers=1)


def _make_topology(pkg):
    def make_topology(accelerator_type: str, worker_id: int = 0):
        m = re.fullmatch(r"h100-(\d+)", accelerator_type)
        assert m, f"twinned tests name line types only, got {accelerator_type}"
        return line(pkg, int(m.group(1)))
    return make_topology


def port_names(src: str) -> str:
    """JAX test-source names read as the port's (PORT_NAMES)."""
    for pat, rep in PORT_NAMES:
        src = re.sub(pat, rep, src)
    return src


def variant_source(name: str, pkg: str, patches=(), extra="",
                   renames=()) -> str:
    src = open(os.path.join(TESTS, name + ".py"), encoding="utf-8").read()
    src += extra
    for tpu_type, n in TYPE_CHIPS.items():
        src = src.replace(f'"{tpu_type}"', f'"h100-{n}"')
    if pkg == "torch":
        src = port_names(src)
        for old, new in renames:
            src = src.replace(old, new)
    for patch in patches:
        old, new = patch[0], patch[1]
        only = patch[2] if len(patch) > 2 else None
        if only not in (None, pkg):
            continue
        assert src.count(old) == 1, (name, pkg, old)
        src = src.replace(old, new)
    return src


@functools.lru_cache(maxsize=None)
def _load(name: str, pkg: str, patches: tuple, extra: str,
          renames: tuple = ()) -> types.ModuleType:
    mod = types.ModuleType(f"twin_{name}_{pkg}")
    mod.__file__ = os.path.join(TESTS, name + ".py")
    sys.modules[mod.__name__] = mod
    exec(compile(variant_source(name, pkg, patches, extra, renames),
                 mod.__file__, "exec"), mod.__dict__)
    mod.make_topology = _make_topology(pkg)
    return mod


def load_variant(name: str, pkg: str, patches=(), extra="",
                 renames=()) -> types.ModuleType:
    """tests/<name>.py bound to `pkg`, with `renames` ((old, new)
    replacements of every occurrence, in the torch variant only) and then
    `patches` ((old, new[, pkg]) source replacements, each matching once)
    applied, and `extra` source (a case written against the module's own
    helpers) appended."""
    return _load(name, pkg, tuple(tuple(p) for p in patches), extra,
                 tuple(tuple(r) for r in renames))


# ---------------------------------------------------------- normalisation

class Norm:
    def __init__(self, pkg: str, root: str):
        self.jax = pkg == "jax"
        self.root = root

    def __call__(self, x, key=""):
        if isinstance(x, dict) and isinstance(x.get("spans"), list):
            x = _trace(x)
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in CLOCK_KEYS:
                    continue
                if k in ID_KEYS:
                    out[k] = "<id>" if v else v
                    continue
                if k in PORT_KEYS:
                    out[k] = _ports(k, v)
                    continue
                if self.jax and k == "id" and isinstance(v, str):
                    v = re.sub(r"^tpu-(\d+)$", r"gpu-\1", v)
                if self.jax and k == "tpu_env" and isinstance(v, dict) \
                        and "TPU_VISIBLE_CHIPS" in v:
                    v = card_env_of(v)
                if self.jax and k == "env" and isinstance(v, list):
                    v = [e for e in v if not e.startswith(XLA_CACHE_ENV)]
                if self.jax and k == "binds" and isinstance(v, list):
                    v = [b for b in v if "/xla-cache:" not in b]
                out[k] = self(v, k)
            return out
        if isinstance(x, (list, tuple)):
            out = [self(v, key) for v in x]
            if key == "traces" and all(isinstance(v, dict) and "rootOp" in v
                                       for v in out):
                out.sort(key=lambda v: json.dumps(v, sort_keys=True))
            return out
        if isinstance(x, str):
            x = x.replace(self.root, "<root>")
            x = _HEX.sub("<id>", x)
            x = _LOOPBACK_PORT.sub("127.0.0.1:<port>", x)
            if self.jax:
                x = x.replace("/dev/accel", "/dev/nvidia").replace(
                    "sched.tpu.", "sched.gpu.")
            if x.startswith("{") or x.startswith("["):
                try:
                    return self(json.loads(x), key)
                except ValueError:
                    return x
            return x
        if isinstance(x, float) and key.endswith(("Ms", "Seconds", "S")):
            return "<clock>"
        return x

    def metrics(self, text: str) -> list:
        """The exposition's families with their TYPE, plus the samples of
        the inventory families (the process-global histograms' children
        carry the whole process's history, so only their family counts)."""
        out = set()
        for ln in text.splitlines():
            if ln.startswith("# TYPE "):
                out.add(ln)
                continue
            if not ln or ln.startswith("#"):
                continue
            name_labels, _, value = ln.rpartition(" ")
            fam = name_labels.split("{")[0]
            if VALUED_FAMILIES.match(fam):
                out.add(f"{name_labels} {value}")
        return sorted(out)


def _trace(t: dict) -> dict:
    """A trace as the multiset of its synchronous spans. The write-behind
    queue's drain spans (workqueue.* and whatever runs under them) batch
    by timing, so they, the counts that include them and the tree (the
    same spans, nested) are dropped; the rest sort canonically."""
    spans = t["spans"]
    drop = {s["spanId"] for s in spans
            if str(s.get("op", "")).startswith("workqueue.")}
    grew = True
    while grew:
        grew = False
        for s in spans:
            if s.get("parentId") in drop and s["spanId"] not in drop:
                drop.add(s["spanId"])
                grew = True
    keep = [s for s in spans if s["spanId"] not in drop]
    out = {k: v for k, v in t.items()
           if k not in ("spans", "tree", "spanCount")}
    out["spans"] = sorted(keep, key=lambda s: json.dumps(
        {k: v for k, v in s.items() if k not in ID_KEYS and k not in
         CLOCK_KEYS}, sort_keys=True, default=str).replace(
            "sched.tpu.", "sched.gpu."))
    return out


def _ports(key, v):
    """Host ports are random picks: a port number reads as <port>, a set
    of them as its size, a port -> owner map as its sorted owners."""
    if isinstance(v, dict):
        if key in ("portBindings", "port_bindings"):
            return {k: "<port>" for k in v}
        return sorted(str(o) for o in v.values())
    if isinstance(v, list):
        return [len(v)]
    if isinstance(v, int) and not isinstance(v, bool):
        return "<port>"
    return v


def _spec_ops(doc: dict) -> list:
    ops = []
    for path, item in doc.get("paths", {}).items():
        ops += [f"{m.upper()} {path}" for m in item
                if m in ("get", "post", "patch", "delete", "put")]
    return sorted(ops)


# --------------------------------------------------------------- recording

class Recorder:
    """The record of one variant's run. `codes_only` keeps each answer's
    request, HTTP status and envelope code alone, and no stored records:
    the record of a race, whose winner is the threads' pick."""

    def __init__(self, pkg: str, root: str, codes_only: bool = False):
        self.pkg = pkg
        self.norm = Norm(pkg, root)
        self.codes_only = codes_only
        self.rows: list = []

    def envelope(self, method, path, status, headers, payload):
        row = {"req": f"{method} {self.norm(urlpath(path))}",
               "status": status,
               "headers": {k: self.norm(v) for k, v in sorted(headers.items())
                           if k in ("Retry-After", "Idempotency-Replayed",
                                    "X-Current-Version")}}
        ctype = headers.get("Content-Type", "")
        if payload is None:
            row["body"] = "<stream>"
        elif ctype.startswith("text/plain"):
            row["body"] = self.norm.metrics(payload.decode())
        elif urlpath(path) == "/openapi.json":
            row["body"] = _spec_ops(json.loads(payload))
        else:
            try:
                row["body"] = self.norm(json.loads(payload) if payload
                                        else None)
            except ValueError:
                row["body"] = self.norm(payload.decode("utf-8", "replace"))
        if self.codes_only:
            body = row.pop("body")
            row["code"] = body.get("code") if isinstance(body, dict) \
                else None
        self.rows.append(row)

    def reconciled(self, report: dict, store):
        if self.codes_only:
            return
        self.rows.append({"reconcile": self.norm(report)})
        self.stored_from(store)

    def stored(self, app):
        if self.codes_only:
            return
        self.stored_from(app.store)

    def stored_from(self, store):
        kvs = {}
        for kv in store.range("/tpu-docker-api/"):
            if "/idempotency/" in kv.key:
                continue
            kvs[kv.key] = self.norm(kv.value)
        self.rows.append({"stored": kvs})


def urlpath(path: str) -> str:
    return path.split("?", 1)[0]


def _wrap_handle(cls, rec_ref):
    orig = cls._handle

    def _handle(self, method, raw_path, body, headers, client_addr=""):
        out = orig(self, method, raw_path, body, headers, client_addr)
        rec = rec_ref[0]
        if rec is not None:
            status, hdrs, payload = out
            rec.envelope(method, raw_path, status, hdrs,
                         payload if isinstance(payload, bytes) else None)
        return out
    _handle.__wrapped__ = orig
    return _handle


def _wrap_reconcile(cls, rec_ref):
    orig = cls.run

    def run(self):
        report = orig(self)
        rec = rec_ref[0]
        if rec is not None:
            rec.reconciled(report, self.client.store)
        return report
    run.__wrapped__ = orig
    return run


def _wrap_stop(cls, rec_ref):
    orig = cls.stop

    def stop(self):
        rec = rec_ref[0]
        if rec is not None and getattr(self, "_twin_recorded", None) is not rec:
            self._twin_recorded = rec
            self.wq.join()
            rec.stored(self)
        return orig(self)
    stop.__wrapped__ = orig
    return stop


# ------------------------------------------------------------- the runner

class _Fixtures:
    """The module's own fixtures, resolved for one variant's call."""

    def __init__(self, mod, tmp_path, monkeypatch):
        self.mod = mod
        self.values = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
        self.teardown: list = []

    def get(self, name):
        if name not in self.values:
            fdef = getattr(self.mod, name)
            fn = fdef._get_wrapped_function()
            args = [self.get(p) for p in inspect.signature(fn).parameters]
            out = fn(*args)
            if inspect.isgenerator(out):
                self.teardown.append(out)
                out = next(out)
            self.values[name] = out
        return self.values[name]

    def autouse(self):
        for name, obj in list(vars(self.mod).items()):
            marker = getattr(obj, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                self.get(name)

    def close(self):
        for gen in reversed(self.teardown):
            for _ in gen:
                pass


def run_variant(mod, pkg, fn_name, tmp_path, params, codes_only=False):
    root = str(tmp_path / pkg)
    os.makedirs(root, exist_ok=True)
    rec = Recorder(pkg, root, codes_only)
    handle_cls = jhttp.ApiServer if pkg == "jax" else thttp.ApiServer
    app_cls = JApp if pkg == "jax" else TApp
    rec_cls = JReconciler if pkg == "jax" else TReconciler
    ref = [rec]
    saved = (handle_cls._handle, app_cls.stop, rec_cls.run)
    handle_cls._handle = _wrap_handle(handle_cls, ref)
    app_cls.stop = _wrap_stop(app_cls, ref)
    rec_cls.run = _wrap_reconcile(rec_cls, ref)
    direct = getattr(mod, "direct", None)
    if direct is not None:
        def recorded_direct(app, method, path, body=None, headers=None):
            resp = direct(app, method, path, body, headers)
            rec.envelope(method, path, resp.http_status, resp.headers,
                         resp.payload())
            return resp
        mod.direct = recorded_direct
    mp = pytest.MonkeyPatch()
    fx = _Fixtures(mod, pathlib.Path(root), mp)
    try:
        fx.autouse()
        fn = getattr(mod, fn_name)
        kwargs = {p: (params[p] if p in params else fx.get(p))
                  for p in inspect.signature(fn).parameters}
        fn(**kwargs)
    finally:
        try:
            fx.close()
        finally:
            mp.undo()
            ref[0] = None
            handle_cls._handle, app_cls.stop, rec_cls.run = saved
            if direct is not None:
                mod.direct = direct
    return rec.rows


def _key(row):
    return json.dumps(row, sort_keys=True, default=str)


def assert_same(jrows, trows):
    jset = sorted(_key(r) for r in jrows)
    tset = sorted(_key(r) for r in trows)
    if jset != tset:
        jn, tn = collections.Counter(jset), collections.Counter(tset)
        only_j = sorted((jn - tn).elements())
        only_t = sorted((tn - jn).elements())
        raise AssertionError(
            "the JAX App and the port's answered differently\n"
            f"only JAX ({len(only_j)}):\n  " + "\n  ".join(only_j[:6])
            + f"\nonly port ({len(only_t)}):\n  " + "\n  ".join(only_t[:6]))


def twin(name, fn_name, tmp_path, params=None, patches=(),
         codes_only=False, extra=""):
    params = params or {}
    jmod = load_variant(name, "jax", patches, extra)
    tmod = load_variant(name, "torch", patches, extra)
    jrows = run_variant(jmod, "jax", fn_name, tmp_path, params, codes_only)
    trows = run_variant(tmod, "torch", fn_name, tmp_path, params, codes_only)
    assert_same(jrows, trows)


def twin_tests(name, select=None, patches=(), races=(), extra="",
               runner=None, exclude=()) -> dict:
    """{test name: test} for every test function of tests/<name>.py
    (or those in `select`) but those in `exclude` (another file twins
    them), each a twin run; parametrize and other marks
    are carried over. The cases named in `races` record codes only
    (Recorder). `runner(fn_name, tmp_path, params)`, when given, runs a
    case in place of `twin`."""
    jmod = load_variant(name, "jax", patches, extra)
    out = {}
    for fn_name, fn in vars(jmod).items():
        if not fn_name.startswith("test_") or not callable(fn):
            continue
        if (select is not None and fn_name not in select) \
                or fn_name in exclude:
            continue
        marks = list(getattr(fn, "pytestmark", []))
        argnames = []
        for m in marks:
            if m.name == "parametrize":
                names = m.args[0]
                argnames += ([n.strip() for n in names.split(",")]
                             if isinstance(names, str) else list(names))

        def test(tmp_path, _fn_name=fn_name, **params):
            if runner is not None:
                runner(_fn_name, tmp_path, params)
            else:
                twin(name, _fn_name, tmp_path, params, patches,
                     codes_only=_fn_name in races, extra=extra)
        sig = [inspect.Parameter("tmp_path",
                                 inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        sig += [inspect.Parameter(a, inspect.Parameter.KEYWORD_ONLY)
                for a in argnames]
        wrapped = _with_signature(test, sig, fn_name)
        module_marks = getattr(jmod, "pytestmark", [])
        if not isinstance(module_marks, list):
            module_marks = [module_marks]
        wrapped.pytestmark = marks + module_marks
        wrapped.__doc__ = fn.__doc__
        out[fn_name] = wrapped
    return out


def _with_signature(runner, params, name):
    def test(*args, **kwargs):
        return runner(*args, **kwargs)
    test.__signature__ = inspect.Signature(params)
    test.__name__ = name
    test.__qualname__ = name
    return test
