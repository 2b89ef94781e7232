"""What the benchmark may import: never JAX or the JAX package, and in the
reference nothing of the program either. Names are compared whole, by
their top-level part: the port's name only begins with the JAX
package's."""

import ast
import json
import os
import sys
import time

import run
from conftest import BENCH_DIR

JAX = {"jax", "jaxlib", "flax", "gpu_docker_api_tpu"}
PORT = "gpu_docker_api_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources(BENCH_DIR):
        names = set(_imports(path))
        assert not names & JAX, (path, names & JAX)
        seen |= names
    assert PORT in seen          # the port itself passes the whole-name rule


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH_DIR, "reference")):
        names = set(_imports(path))
        assert PORT not in names and not names & JAX, (path, names)
        assert names <= {"__future__", "dataclasses", "json", "math",
                         "statistics", "torch"}, (path, names)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpu_docker_api_tpu_torch_fake",
                        sys.modules[__name__])
    assert "gpu_docker_api_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys.modules[__name__])
    assert "jaxlib" in run.forbidden_modules()


def test_a_run_whose_server_loaded_the_jax_package_is_refused(
        tiny, tmp_path, monkeypatch, capsys):
    """The serving cell's program runs in a child process: a JAX package
    module planted there (at the interpreter's start) refuses the run, with
    no result line, as one in the harness's own process would."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\n"
        "sys.modules['gpu_docker_api_tpu'] = types.ModuleType("
        "'gpu_docker_api_tpu')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ["PYTHONPATH"]]))
    root, bench, path = tiny
    result = run.run_cell("tiny.dense.serve", 3, 1.0, False, device="cpu",
                          t0=time.perf_counter(), manifest_path=path,
                          bench_dir=bench)
    assert result["forbidden"] == ["gpu_docker_api_tpu"]
    capsys.readouterr()
    assert run.report(result) == 3
    out = capsys.readouterr()
    assert out.out == "" and "gpu_docker_api_tpu" in out.err


def test_a_clean_run_reports_its_line(tiny, capsys):
    root, bench, path = tiny
    result = run.run_cell("tiny.dense.serve", 4, 1.0, False, device="cpu",
                          t0=time.perf_counter(), manifest_path=path,
                          bench_dir=bench)
    assert result["forbidden"] == []
    assert run.report(result) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert list(json.loads(line))[-1] == "checks"
