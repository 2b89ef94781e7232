"""BENCHMARK.json, and the files it names found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The harness finds, under the benchmark's folder:

- the configuration at the `file` its `configs` entry gives;
- the traffic mix at traffic/<traffic>.json, whose `kind` names the
  driver at drivers/<kind>.py and, for serving, whose `generator` names
  the module that draws its requests at generators/<generator>.py;
- the cell's correctness limits at limits/<workload>.json;
- each per-layer metric's reader at metrics/<name>.py, a module with
  read(summary) -> number or None.

So a configuration, a mix, a metric or a cell is added as files and
entries, with no edit to a file already here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    workload: dict
    config_name: str
    config_path: str
    config: dict            # the configuration file's contents
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list        # metric entries this cell reports
    per_layer: list
    bench_dir: str
    root: str


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest_path: str = "", bench_dir: str = "") -> Cell:
    """The cell `name` of the manifest with every file it needs loaded.
    KeyError names what is missing."""
    bench_dir = bench_dir or BENCH_DIR
    root = os.path.dirname(bench_dir)
    manifest_path = manifest_path or os.path.join(root, "BENCHMARK.json")
    m = load_json(manifest_path)
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {manifest_path} "
                       f"(have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in m["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=name, workload=w, config_name=conf["name"],
        config_path=os.path.join(root, conf["file"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(bench_dir, "limits", name + ".json")),
        end_to_end=[x for x in m["end_to_end"] if _applies(x, name)],
        per_layer=[x for x in m["per_layer"] if _applies(x, name)],
        bench_dir=bench_dir, root=root)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise KeyError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(c: Cell):
    """The module that runs cells of this traffic kind."""
    kind = c.traffic["kind"]
    return _module(os.path.join(c.bench_dir, "drivers", kind + ".py"),
                   f"bench_driver_{kind}")


def generator(c: Cell):
    """The module that draws this traffic mix's requests:
    generators/<generator>.py, arrivals.py where the mix names none."""
    name = c.traffic.get("generator", "arrivals")
    return _module(os.path.join(c.bench_dir, "generators", name + ".py"),
                   "bench_generator_" + name)


def reader(c: Cell, metric: str):
    """metrics/<metric>.py's read(summary)."""
    return _module(os.path.join(c.bench_dir, "metrics", metric + ".py"),
                   "bench_metric_" + metric.replace(".", "_")).read


def per_layer_values(c: Cell, summary: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    reader found something in `summary`."""
    out = {}
    for m in c.per_layer:
        value = reader(c, m["name"])(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
