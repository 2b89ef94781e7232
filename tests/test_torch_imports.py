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


def test_chip_smoke_imports_nothing_of_jax():
    names = set(_imports(os.path.join(REPO, "chip_smoke.py")))
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "gpu_docker_api_tpu")}


def test_every_kernel_source_is_listed_for_the_build():
    from gpu_docker_api_tpu_torch import _build
    csrc = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert csrc == sorted(src for src, _ in _build.KERNELS.values())
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
    csrc/*.cu, each parameter "pointer" or "int"."""
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
                elif re.fullmatch(r"(const )?int \w+", p):
                    kinds.append("int")
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
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}
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
