"""Each kind of cell run end to end on the CPU at a tiny configuration that
BENCHMARK.json does not name: the harness's look for a card skipped, the
rest of a run driven. Sound runs come out correct; the float8 control and
every planted fault come out not correct."""

import time

import pytest

import manifest
import run
from reference import compare

TRAIN = ["tiny.dense.train", "tiny.moe.train"]


def _run(tiny, name, trace=False, seconds=0.5, **options):
    root, bench, path = tiny
    return run.run_cell(name, 2 ** 31 + 12345, seconds, trace, device="cpu",
                        t0=time.perf_counter(), manifest_path=path,
                        bench_dir=bench, **options)


def _verdict(tiny, name, **options):
    """correct, as run_cell decides it, for a run with options: no window
    for training (set-up drives the steps that are checked), a short one
    for serving."""
    root, bench, path = tiny
    c = manifest.cell(name, path, bench)
    seconds = 3.0 if c.traffic["kind"] == "serve" else 0.0
    out = manifest.driver(c).run(c, 99, seconds, False, "cpu",
                                 time.perf_counter(), **options)
    return compare.verdict(out["numbers"], c.limits)[0], out["numbers"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("trace", [False, True])
def test_train_cell_runs_correct(tiny, name, trace):
    r = _run(tiny, name, trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"change_gap", "grad_diff"}
    assert set(r["reported"]) == {"loss_gap", "grad_gap"}
    if trace:
        assert r["device"]["window_s"] > 0 and "breakdown" in r
        assert r["metrics"] == {}        # a CPU run reads no device metric
    else:
        assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_serve_cell_runs_correct(tiny):
    r = _run(tiny, "tiny.dense.serve", seconds=3.0)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == 18
    assert set(r["metrics"]) == {"serve_latency_p90_ms",
                                 "serve_tokens_per_s", "setup_s"}


def test_traced_serve_cell_reads_the_batcher(tiny):
    r = _run(tiny, "tiny.dense.serve", trace=True, seconds=3.0)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"queue_wait_p90_ms.serve"}
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_is_not_correct(tiny, name):
    ok, numbers = _verdict(tiny, name, control=True)
    assert not ok, numbers


def test_serve_control_is_not_correct(tiny):
    ok, numbers = _verdict(tiny, "tiny.dense.serve", control=True)
    assert not ok, numbers


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_not_correct(tiny, name, fault):
    ok, numbers = _verdict(tiny, name, fault=fault)
    assert not ok, numbers


def test_serve_altered_token_is_not_correct(tiny):
    ok, numbers = _verdict(tiny, "tiny.dense.serve", fault="token")
    assert not ok, numbers


@pytest.mark.card
def test_train_cell_on_the_card(tiny, card):
    root, bench, path = tiny
    r = run.run_cell("tiny.dense.train", 5, 0.5, False, device="cuda",
                     t0=time.perf_counter(), manifest_path=path,
                     bench_dir=bench)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
