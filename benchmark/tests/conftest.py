"""Fixtures of the benchmark's CPU tests: the harness on sys.path, and a
tiny temporary copy of the benchmark (configurations at a CPU size, the
same drivers, readers and reference) that no BENCHMARK.json of the repo
names.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

# correctness limits of the tiny cells, from their own CPU readings:
# sound runs read change 1e-3..2.4e-3, grad_diff about 0.008 and a served
# gap of 0..0.008; the float8 control grad_diff 0.08..0.19 and served gap
# 0.14..0.21, half the batch change 0.25, an altered token 2.6..3.1
TINY_LIMITS = {
    "train": {"change_gap": 0.1, "grad_diff": 0.04},
    "serve": {"served_gap": 0.05},
}
TINY_CELLS = {"tiny.dense.train": ("tiny_dense", "tiny_train"),
              "tiny.moe.train": ("tiny_moe", "tiny_train"),
              "tiny.dense.serve": ("tiny_wide", "tiny_serve")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def make_tiny(dst: str) -> str:
    """A copy of the benchmark under dst/benchmark with tiny cells, and
    dst/BENCHMARK.json naming only them. Returns dst."""
    bench = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    small = dict(hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=2, intermediate_size=96,
                 vocab_size=256, num_hidden_layers=2,
                 max_position_embeddings=128)
    dense = _load(os.path.join(BENCH_DIR, "configs", "mistral_7b.json"))
    dense.update(small, sliding_window=16, assumed={"head_dim": 16})
    # served at a width whose logits spread like the full model's (std
    # 0.02 * sqrt(width)), so that near ties are rare enough to tell a
    # float8 forward from a sound one
    wide = dict(dense, hidden_size=1024, num_attention_heads=8,
                intermediate_size=1536, assumed={"head_dim": 128})
    moe = _load(os.path.join(BENCH_DIR, "configs", "mixtral_8x7b.json"))
    moe.update(small, num_local_experts=4,
               assumed=dict(moe["assumed"], head_dim=16))
    _dump(dense, os.path.join(bench, "configs", "tiny_dense.json"))
    _dump(wide, os.path.join(bench, "configs", "tiny_wide.json"))
    _dump(moe, os.path.join(bench, "configs", "tiny_moe.json"))
    train = _load(os.path.join(bench, "traffic", "train_b1_s8192.json"))
    train.update(batch=2, seq=32)
    _dump(train, os.path.join(bench, "traffic", "tiny_train.json"))
    serve = _load(os.path.join(bench, "traffic", "code_completion.json"))
    serve.update(server_args=["--batch-slots", "4", "--batch-max-len", "128",
                              "--batch-prefill-chunk", "16"],
                 rate_per_s=6.0,
                 prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 96},
                 output={"median": 6, "sigma": 0.5, "min": 4, "max": 16},
                 warmup={"requests": 4}, check_requests=12)
    _dump(serve, os.path.join(bench, "traffic", "tiny_serve.json"))
    m = _load(os.path.join(REPO, "BENCHMARK.json"))
    real = {w["name"]: w for w in m["workloads"]}
    kinds = {"mistral7b.train.s8192": "tiny.dense.train",
             "mixtral8x7b.train.s4096": "tiny.moe.train",
             "mistral7b.serve.code": "tiny.dense.serve"}
    assert set(kinds) == set(real)
    m["configs"] = [{"name": n, "source": "test", "reduced": [], "why": "test",
                     "file": f"benchmark/configs/{n}.json"}
                    for n in ("tiny_dense", "tiny_moe", "tiny_wide")]
    m["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "test"} for n, (c, t) in TINY_CELLS.items()]
    for metric in m["end_to_end"] + m["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [kinds[w] for w in metric["workloads"]]
    _dump(m, os.path.join(dst, "BENCHMARK.json"))
    for name in TINY_CELLS:
        kind = "serve" if name.endswith("serve") else "train"
        _dump(TINY_LIMITS[kind], os.path.join(bench, "limits",
                                              name + ".json"))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, bench_dir, manifest) of the tiny copy, shared by the session;
    the serving child finds the program through PYTHONPATH."""
    root = make_tiny(str(tmp_path_factory.mktemp("tinybench")))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + old if old else "")
    import run
    run.set_environment(root)
    yield root, os.path.join(root, "benchmark"), os.path.join(
        root, "BENCHMARK.json")
    if old is None:
        os.environ.pop("PYTHONPATH", None)
    else:
        os.environ["PYTHONPATH"] = old


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
