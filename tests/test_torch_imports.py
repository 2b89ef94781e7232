"""The PyTorch port stands alone: it imports neither jax nor anything of the
JAX package (gpu_docker_api_tpu), and importing it builds nothing."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import gpu_docker_api_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)

IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None          # any `import jax` now raises
import gpu_docker_api_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                "gpu_docker_api_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "gpu_docker_api_tpu"
                or m.startswith("gpu_docker_api_tpu.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
from gpu_docker_api_tpu_torch import _build
print(json.dumps({"n": len(names), "leaked": leaked,
                  "loaded": sorted(_build._loaded)}))
"""


def _modules():
    return [m.name for m in pkgutil.walk_packages(
        port.__path__, "gpu_docker_api_tpu_torch.")]


def test_port_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, REPO],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] >= 14                # every module of the port imported
    assert got["leaked"] == []
    assert got["loaded"] == []           # no kernel built or loaded at import


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for name in _imports(path):
                    top = name.split(".")[0]
                    if top in ("jax", "jaxlib", "optax", "orbax", "flax",
                               "gpu_docker_api_tpu"):
                        bad.append((os.path.relpath(path, REPO), name))
    assert bad == []


def test_paging_and_kvaffinity_are_walked_and_kvaffinity_is_its_own():
    """The paged cache and the sketch module are modules of the port, and
    the port's kvaffinity is its own code, not the JAX module re-exported
    (that one is stdlib-only too, so only its identity tells)."""
    assert {"gpu_docker_api_tpu_torch.paging",
            "gpu_docker_api_tpu_torch.kvaffinity"} <= set(_modules())
    from gpu_docker_api_tpu_torch import kvaffinity
    assert os.path.dirname(kvaffinity.__file__) == PORT_DIR
    for name in ("chunk_hashes", "build_sketch", "encode_sketch_hex",
                 "decode_sketch_hex", "hit_tokens", "score", "signed64"):
        assert getattr(kvaffinity, name).__module__ == kvaffinity.__name__


def test_the_moe_family_is_walked_and_scanned():
    """models/moe.py is a module of the port, imported with jax blocked
    (test_port_imports_with_jax_blocked) and inside the source scan."""
    assert "gpu_docker_api_tpu_torch.models.moe" in set(_modules())
    path = os.path.join(PORT_DIR, "models", "moe.py")
    assert {n.split(".")[0] for n in _imports(path)} <= {
        "__future__", "dataclasses", "torch"}


def test_the_sp_modules_are_walked_and_scanned():
    """The sequence-parallel modules are modules of the port, imported with
    jax blocked (test_port_imports_with_jax_blocked) and inside the source
    scan; distributed.py is the port's own, not the JAX module's."""
    names = {"gpu_docker_api_tpu_torch.distributed",
             "gpu_docker_api_tpu_torch.parallel.comm",
             "gpu_docker_api_tpu_torch.parallel.ring",
             "gpu_docker_api_tpu_torch.parallel.ulysses"}
    assert names <= set(_modules())
    allowed = {"__future__", "dataclasses", "typing", "math", "torch",
               "datetime", "multiprocessing", "os", "signal", "socket",
               "tempfile", "threading", "time"}
    for rel in ("distributed.py", "parallel/comm.py", "parallel/ring.py",
                "parallel/ulysses.py"):
        path = os.path.join(PORT_DIR, rel)
        assert {n.split(".")[0] for n in _imports(path)} <= allowed, rel
    from gpu_docker_api_tpu_torch import distributed
    assert distributed.cluster_spec_from_env.__module__ == distributed.__name__


def test_the_node_layer_is_walked_and_scanned():
    """The control plane's node layer is the port's own: its subpackages
    (obs, store, schedulers, backend) and modules are walked, imported with
    jax blocked (test_port_imports_with_jax_blocked) and import nothing of
    gpu_docker_api_tpu; the node layer imports no torch either."""
    mods = set(_modules())
    subpackages = ("obs", "store", "schedulers", "backend", "utils")
    modules = ("xerrors", "faults", "meshplan", "topology", "workqueue",
               "dtos", "obs.trace", "obs.metrics", "store.walio",
               "store.mvcc", "store.client", "schedulers.base",
               "schedulers.gpu", "backend.base", "backend.process",
               "utils.file")
    assert {f"gpu_docker_api_tpu_torch.{m}"
            for m in subpackages + modules} <= mods
    for m in subpackages + modules:
        rel = m.replace(".", "/")
        path = os.path.join(PORT_DIR, rel, "__init__.py") \
            if m in subpackages else os.path.join(PORT_DIR, rel + ".py")
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "gpu_docker_api_tpu", "torch"}, m
    import importlib
    for m in ("topology", "schedulers.gpu", "store.mvcc", "backend.process"):
        mod = importlib.import_module(f"gpu_docker_api_tpu_torch.{m}")
        assert os.path.dirname(mod.__file__).startswith(PORT_DIR)


def test_the_services_and_their_substrate_are_walked_and_scanned():
    """The services slice is the port's own: the services, the backends
    (mock, guarded, docker, the warm pool), the CPU and port schedulers,
    the version maps, idempotency, the intent journal, the event log, the
    rotating writer, copyfast and lockwatch are walked, imported with jax
    blocked (test_port_imports_with_jax_blocked), import nothing of
    gpu_docker_api_tpu, and import no torch either (the warm pool's worker
    imports torch only in the worker process, from its source string)."""
    mods = set(_modules())
    subpackages = ("services", "analysis")
    modules = ("version", "idempotency", "intents", "events", "obs.rotate",
               "schedulers.cpu", "schedulers.port", "utils.copyfast",
               "backend.mock", "analysis.lockwatch", "backend.guard",
               "services.volume", "services.replicaset", "backend.docker",
               "backend.warmpool")
    assert {f"gpu_docker_api_tpu_torch.{m}"
            for m in subpackages + modules} <= mods
    for m in subpackages + modules:
        rel = m.replace(".", "/")
        path = os.path.join(PORT_DIR, rel, "__init__.py") \
            if m in subpackages else os.path.join(PORT_DIR, rel + ".py")
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "gpu_docker_api_tpu", "torch"}, m
        assert "jax" not in open(path, encoding="utf-8").read().replace(
            "JAX", ""), m
    import importlib
    for m in modules:
        mod = importlib.import_module(f"gpu_docker_api_tpu_torch.{m}")
        assert os.path.dirname(mod.__file__).startswith(PORT_DIR)
    from gpu_docker_api_tpu_torch.services import ReplicaSetService
    from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
    import inspect
    assert inspect.signature(ReplicaSetService).parameters[
        "tpu"].annotation in (GpuScheduler, "GpuScheduler")


def test_chip_smoke_imports_nothing_of_jax():
    names = set(_imports(os.path.join(REPO, "chip_smoke.py")))
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "gpu_docker_api_tpu")}


def test_every_kernel_source_is_listed_for_the_build():
    from gpu_docker_api_tpu_torch import _build
    csrc = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    # a source may hold several entry points (optim.cu), one library each
    assert csrc == sorted({src for src, _ in _build.KERNELS.values()})
    assert (_build._lib_path("sum_squares") == _build._lib_path("adamw")
            != _build._lib_path("flash_fwd"))
    assert all((_build.CSRC / h).exists() for h in _build.HEADERS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the library name follows the sources: stable across calls
    assert _build._lib_path("flash_fwd") == _build._lib_path("flash_fwd")
    assert len(_modules()) >= 12


def test_no_kernel_source_uses_wmma():
    """Every bf16 kernel is the wgmma design: no source under csrc/ reaches
    the WMMA API (f32 runs on the CUDA cores)."""
    from gpu_docker_api_tpu_torch import _build
    users = []
    for f in sorted(os.listdir(_build.CSRC)):
        text = open(_build.CSRC / f, encoding="utf-8").read()
        users += [(f, x) for x in ("nvcuda", "wmma::", "<mma.h>") if x in text]
    assert users == []


def _c_entry_points():
    """{name: [parameter kinds]} of every `extern "C" int name(...)` in
    csrc/*.cu, each parameter "pointer", "int", "long long" or "float"."""
    import re
    from gpu_docker_api_tpu_torch import _build
    found = {}
    for f in sorted(os.listdir(_build.CSRC)):
        if not f.endswith(".cu"):
            continue
        text = open(_build.CSRC / f, encoding="utf-8").read()
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append("pointer")
                elif m := re.fullmatch(r"(const )?(int|long long|float) \w+",
                                       p):
                    kinds.append(m.group(2))
                else:
                    kinds.append(f"unknown: {p}")
            found[name] = kinds
    return found


def test_every_c_entry_point_matches_its_ctypes_argtypes():
    """ctypes passes whatever argtypes say: a pointer declared c_int would be
    cut to 32 bits, an argument missing from the list would shift the rest.
    Each extern "C" signature must match [c_int, *KERNELS[name][1]]."""
    import ctypes
    from gpu_docker_api_tpu_torch import _build
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
            ctypes.c_longlong: "long long", ctypes.c_float: "float"}
    found = _c_entry_points()
    assert sorted(found) == sorted(_build.KERNELS)
    for name, (_, argtypes) in _build.KERNELS.items():
        assert found[name] == [kind[t] for t in (ctypes.c_int, *argtypes)], name


def test_chip_smoke_alone_or_without_a_card_fails_and_prints_no_result(
        tmp_path):
    """chip_smoke.py exits non-zero with no result line where there is no
    card, and where the directory holds nothing else of the repo."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (str(tmp_path), REPO):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, OMP_NUM_THREADS="1",
                                      PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_the_daemon_is_walked_and_scanned():
    """The daemon slice is the port's own: the REST server and its codes,
    the App, the reconciler, the health monitor, federation's watch half,
    the telemetry catalog and flight recorder, the client and the cli are
    walked, imported with jax blocked (test_port_imports_with_jax_blocked),
    import nothing of gpu_docker_api_tpu and no torch either (the daemon is
    a control-plane process: it never touches the card's driver)."""
    mods = set(_modules())
    subpackages = ("server",)
    modules = ("server.codes", "server.http", "server.app", "obs.names",
               "obs.recorder", "obs.metrics", "obs.trace", "federation",
               "health", "reconcile", "client", "cli", "regulator",
               "metrics", "utils.file")
    assert {f"gpu_docker_api_tpu_torch.{m}"
            for m in subpackages + modules} <= mods
    for m in subpackages + modules:
        rel = m.replace(".", "/")
        path = os.path.join(PORT_DIR, rel, "__init__.py") \
            if m in subpackages else os.path.join(PORT_DIR, rel + ".py")
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "gpu_docker_api_tpu", "torch"}, m
        assert "jax" not in open(path, encoding="utf-8").read().replace(
            "JAX", ""), m
    import importlib
    for m in modules:
        mod = importlib.import_module(f"gpu_docker_api_tpu_torch.{m}")
        assert os.path.dirname(mod.__file__).startswith(PORT_DIR)
    from gpu_docker_api_tpu_torch.server.app import App
    from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
    assert App.__module__ == "gpu_docker_api_tpu_torch.server.app"
    assert GpuScheduler.__module__.startswith("gpu_docker_api_tpu_torch.")


def test_the_serving_control_plane_is_walked_and_scanned():
    """The serving control plane is the port's own: tail tolerance, the
    mock replica, the gateway, the native loader, the worker tier's shm
    metrics and span spool, and the SO_REUSEPORT workers are walked,
    imported with jax blocked (test_port_imports_with_jax_blocked), import
    nothing of gpu_docker_api_tpu and no torch, and the native loader
    builds into the port's own build directory, never native/build."""
    mods = set(_modules())
    modules = ("tailtolerance", "workloads.mock_model", "gateway", "_native",
               "obs.shm_metrics", "obs.spool", "server.workers")
    assert {f"gpu_docker_api_tpu_torch.{m}" for m in modules} <= mods
    for m in modules:
        path = os.path.join(PORT_DIR, m.replace(".", "/") + ".py")
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "gpu_docker_api_tpu", "torch"}, m
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "sys.modules['jax'] = None\n"
         "import gpu_docker_api_tpu_torch.server.workers, "
         "gpu_docker_api_tpu_torch.gateway, "
         "gpu_docker_api_tpu_torch.workloads.mock_model\n"
         "print('torch' in sys.modules)", REPO],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    from gpu_docker_api_tpu_torch import _native
    build = os.path.join(PORT_DIR, "build")
    assert _native._LIB_SOURCES == {"mvccstore": "mvcc_store.cc",
                                    "topoalloc": "topology_alloc.cc",
                                    "shmatomics": "shm_atomics.cc"}
    for lib in _native._LIB_SOURCES:
        assert os.path.dirname(str(_native.lib_path(lib))) == build


def test_the_fleet_and_the_native_engines_are_walked_and_scanned():
    """The last modules of the JAX package are the port's own: federation
    (both halves), replication, the fleet plane, placement, defrag and the
    native store are walked, imported with jax blocked
    (test_port_imports_with_jax_blocked), import nothing of
    gpu_docker_api_tpu and no torch: they are control-plane modules. With
    them the port has a counterpart of every module of the JAX package."""
    mods = set(_modules())
    modules = ("federation", "replication", "server.fleet", "placement",
               "defrag", "store.native")
    assert {f"gpu_docker_api_tpu_torch.{m}" for m in modules} <= mods
    for m in modules:
        path = os.path.join(PORT_DIR, m.replace(".", "/") + ".py")
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "gpu_docker_api_tpu", "torch"}, m
        assert "jax" not in open(path, encoding="utf-8").read().replace(
            "JAX", ""), m
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "sys.modules['jax'] = None\n"
         "import gpu_docker_api_tpu_torch.federation, "
         "gpu_docker_api_tpu_torch.replication, "
         "gpu_docker_api_tpu_torch.server.fleet, "
         "gpu_docker_api_tpu_torch.placement, "
         "gpu_docker_api_tpu_torch.defrag, "
         "gpu_docker_api_tpu_torch.store.native\n"
         "print('torch' in sys.modules)", REPO],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    jax_dir = os.path.join(REPO, "gpu_docker_api_tpu")
    jax_mods = {os.path.relpath(os.path.join(d, f), jax_dir)
                for d, _, fs in os.walk(jax_dir) for f in fs
                if f.endswith(".py") and "__pycache__" not in d}
    port_mods = {os.path.relpath(os.path.join(d, f), PORT_DIR)
                 for d, _, fs in os.walk(PORT_DIR) for f in fs
                 if f.endswith(".py") and "__pycache__" not in d}
    assert jax_mods - port_mods <= {"schedulers/tpu.py"}, \
        sorted(jax_mods - port_mods)
