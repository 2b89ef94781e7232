"""The manifest and the files it names: found by name, to the contract's
shape, and extensible by adding files and entries only."""

import json
import os
import re
import time

import manifest
import run
from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _manifest():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_manifest_shape():
    m = _manifest()
    assert set(m) == TOP
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        names.add(c["name"])
    cells = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        cells.add(w["name"])
    assert {w["config"] for w in m["workloads"]} == names
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in (
            "host_clock", "device_trace")
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= cells
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        # each cell it lists reports the metric it moves
        moved = e2e[x["moves"]].get("workloads", cells)
        assert set(x["workloads"]) <= set(moved)
    for cell in cells:
        reported = [x for x in m["end_to_end"]
                    if cell in x.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in x["workloads"] for x in m["per_layer"])


def test_cells_find_their_files_by_name():
    for w in _manifest()["workloads"]:
        c = manifest.cell(w["name"])
        assert c.config_name == w["config"]
        assert c.traffic["kind"] in ("train", "serve")
        assert manifest.driver(c).run
        assert c.limits and all(isinstance(v, float) for k, v in
                                c.limits.items() if not k.startswith("_"))
        for m in c.per_layer:
            assert callable(manifest.reader(c, m["name"]))


def test_readers_find_nothing_in_a_cpu_trace():
    """A run without a card traces no device time: every reader returns
    nothing rather than a zero."""
    summary = {"kind": "train", "busy_s": 0.0, "window_s": 1.0, "steps": 2,
               "family_s": {}, "launches": {}, "moe": True,
               "step_flops": 1.0, "attention": {}}
    c = manifest.cell("mixtral8x7b.train.s4096")
    assert manifest.per_layer_values(c, summary) == {}


DUMMY_GENERATOR = """
import numpy as np


def requests(mix, seed, seconds, vocab, rate=0.0):
    rate = rate or mix["rate_per_s"]
    ids = np.random.default_rng(seed)
    return [{"due": i / rate,
             "prompt": ids.integers(0, vocab, mix["prompt_len"]).tolist(),
             "max_new": mix["max_new"]}
            for i in range(max(1, round(rate * seconds)))]
"""


def test_a_config_mix_and_metric_are_added_as_files(tiny):
    """A dummy configuration, traffic mix, metric and cell, and a serving
    mix with a generator module of its own, added to the tiny copy as new
    files and entries only, and run."""
    root, bench, path = tiny
    import shutil
    extra = os.path.join(os.path.dirname(root), "extended")
    shutil.copytree(root, extra)
    b = os.path.join(extra, "benchmark")
    with open(os.path.join(b, "configs", "tiny_dense.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = 1
    with open(os.path.join(b, "configs", "dummy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "tiny_train.json")) as f:
        mix = json.load(f)
    mix["seq"] = 16
    with open(os.path.join(b, "traffic", "dummy_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "metrics", "dummy_steps.py"), "w") as f:
        f.write("def read(summary):\n    return float(summary['steps'])\n")
    with open(os.path.join(b, "limits", "dummy.cell.json"), "w") as f:
        json.dump({"change_gap": 0.1}, f)
    # a serving mix whose traffic needs new code: a generator of its own
    with open(os.path.join(b, "generators", "dummy_even.py"), "w") as f:
        f.write(DUMMY_GENERATOR)
    with open(os.path.join(b, "traffic", "tiny_serve.json")) as f:
        smix = json.load(f)
    smix.update(generator="dummy_even", prompt_len=12, max_new=4)
    with open(os.path.join(b, "traffic", "dummy_even_mix.json"), "w") as f:
        json.dump(smix, f)
    with open(os.path.join(b, "limits", "dummy.serve.json"), "w") as f:
        json.dump({"served_gap": 0.05}, f)
    with open(os.path.join(extra, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "dummy", "source": "test", "reduced": [],
                         "why": "test", "file": "benchmark/configs/dummy.json"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy",
                           "traffic": "dummy_mix", "chips": 1, "why": "test"})
    m["workloads"].append({"name": "dummy.serve", "config": "tiny_wide",
                           "traffic": "dummy_even_mix", "chips": 1,
                           "why": "test"})
    m["end_to_end"][0]["workloads"].append("dummy.cell")
    for metric in m["end_to_end"]:
        if "tiny.dense.serve" in metric.get("workloads", []):
            metric["workloads"].append("dummy.serve")
    m["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": m["end_to_end"][0]["name"],
                           "workloads": ["dummy.cell"]})
    with open(os.path.join(extra, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    r = run.run_cell("dummy.cell", 7, 0.5, True, device="cpu",
                     t0=time.perf_counter(),
                     manifest_path=os.path.join(extra, "BENCHMARK.json"),
                     bench_dir=b)
    assert r["correct"] is True
    assert r["metrics"]["dummy_steps"]["value"] >= 1
    r = run.run_cell("dummy.serve", 7, 2.0, False, device="cpu",
                     t0=time.perf_counter(),
                     manifest_path=os.path.join(extra, "BENCHMARK.json"),
                     bench_dir=b)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == 12          # 6 a second, evenly spaced
    assert r["worst"]["served_tokens"] == 4 * r["worst"]["sampled"]
