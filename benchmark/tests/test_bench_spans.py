"""spantrace's attribution of device time and idle to the program's
hot-path spans, and the readers of the span and counter metrics, on
synthetic event lists and summaries (and one CPU profile)."""

import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

import devtrace
import spantrace

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"),
        os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_innermost_follows_the_nesting():
    spans = [("train.step", 0, 100), ("train.forward", 10, 40),
             ("train.backward", 40, 80), ("train.optimizer", 85, 101)]
    assert spantrace.innermost(spans) == [
        (0, 10, "train.step"), (10, 40, "train.forward"),
        (40, 80, "train.backward"), (80, 85, "train.step"),
        (85, 100, "train.optimizer")]
    deep = [("serve.tick", 0, 50), ("serve.admit", 5, 30),
            ("serve.prefill_piece", 10, 20), ("serve.sleep", 60, 70)]
    assert spantrace.innermost(deep) == [
        (0, 5, "serve.tick"), (5, 10, "serve.admit"),
        (10, 20, "serve.prefill_piece"), (20, 30, "serve.admit"),
        (30, 50, "serve.tick"), (60, 70, "serve.sleep")]


def test_kernels_go_to_the_span_innermost_at_their_launch():
    spans = [("train.step", 0, 100), ("train.forward", 10, 40),
             ("train.backward", 40, 80), ("train.grad_norm", 80, 85),
             ("train.optimizer", 85, 100)]
    kernels = [
        ("gemm", 12, 30, 11),          # launched in forward
        ("gemm_bwd", 45, 70, 41),      # backward, from the autograd thread
        ("late_bwd", 82, 90, 79),      # runs later, launched in backward
        ("norm", 90, 92, 81),
        ("adam", 92, 99, 86),
        ("step_tail", 99, 100, 82.5),
        ("outside", 100, 104, 150),    # launched after every span
        ("unlinked", 104, 105, None),
    ]
    out = spantrace.attribute(kernels, spans, [], (0, 110))
    assert out["span_device_s"] == pytest.approx({
        "train.forward": 18e-6, "train.backward": 33e-6,
        "train.grad_norm": 3e-6, "train.optimizer": 7e-6})
    assert out["unattributed_device_s"] == pytest.approx(5e-6)
    total = sum(out["span_device_s"].values()) + out["unattributed_device_s"]
    assert total == pytest.approx(sum(e - s for _, s, e, _ in kernels) / 1e6)


def test_idle_is_cut_at_the_spans_edges():
    spans = [("serve.tick", 0, 40), ("serve.decode_step", 10, 30),
             ("serve.sleep", 50, 60)]
    kernels = [("k", 12, 20, 11), ("k2", 32, 34, 31)]
    host = [("aten::item", 25, 29)]
    out = spantrace.attribute(kernels, spans, host, (0, 70))
    # idle [0, 12), [20, 32), [34, 70)
    assert out["span_idle_s"] == pytest.approx({
        "serve.tick": 18e-6, "serve.decode_step": 12e-6,
        "serve.sleep": 10e-6})
    # each gap named by the op open at its middle, else the innermost span
    assert dict(out["span_idle_gaps"]) == pytest.approx({
        "serve.tick": 12e-6, "aten::item": 12e-6, "serve.sleep": 36e-6})


def _evt(name, s, e, device=CPU, id=0, linked=0, thread=1, annot=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s,
                                                                 end=e),
                           device_type=device, id=id,
                           linked_correlation_id=linked, thread=thread,
                           is_user_annotation=annot)


def _prof(events):
    return SimpleNamespace(events=lambda: events)


def test_from_profiler_links_by_correlation_id():
    events = [
        _evt(devtrace.WINDOW, 0, 200, annot=True),
        _evt(devtrace.WINDOW, 0, 200, device=CUDA, annot=True),
        _evt("train.step", 5, 150, thread=1),
        _evt("train.forward", 10, 50, thread=1),
        _evt("train.backward", 50, 120, thread=1),
        _evt("train.optimizer", 125, 150, thread=1),
        # a stray span on another thread is not the traced thread's
        _evt("serve.tick", 0, 200, thread=9),
        _evt("aten::mm", 11, 13, id=7, thread=1),
        _evt("cudaLaunchKernel", 12, 13, id=1001, linked=7, thread=1),
        _evt("gemm", 20, 60, device=CUDA, id=1001, linked=7),
        # the backward's kernel, launched from the autograd thread
        _evt("aten::mm", 60, 62, id=8, thread=2),
        _evt("cudaLaunchKernel", 61, 62, id=1002, linked=8, thread=2),
        _evt("gemm_bwd", 70, 125, device=CUDA, id=1002, linked=8),
        # no runtime event: its CPU op's start puts it in the optimizer
        _evt("aten::add_", 130, 131, id=9, thread=1),
        _evt("adam", 140, 146, device=CUDA, id=1003, linked=9),
        # launched before the step, no span
        _evt("cudaLaunchKernel", 1, 2, id=1004, thread=1),
        _evt("randint", 3, 6, device=CUDA, id=1004),
    ]
    got = spantrace.from_profiler(_prof(events))
    assert got["span_device_s"] == pytest.approx({
        "train.forward": 40e-6, "train.backward": 55e-6,
        "train.optimizer": 6e-6})
    assert got["unattributed_device_s"] == pytest.approx(3e-6)
    # devtrace's keys of the same events are its own, unchanged
    s = devtrace.from_profiler(_prof(events))
    assert s["busy_s"] == pytest.approx((3 + 40 + 55 + 6) / 1e6)


def test_a_trace_without_spans_attributes_nothing():
    events = [_evt(devtrace.WINDOW, 0, 100, annot=True),
              _evt("cudaLaunchKernel", 1, 2, id=5),
              _evt("k", 10, 20, device=CUDA, id=5)]
    got = spantrace.from_profiler(_prof(events))
    assert got["span_device_s"] == {} and got["span_idle_s"] == {}
    assert got["unattributed_device_s"] == pytest.approx(10e-6)
    assert dict(got["span_idle_gaps"]) == pytest.approx(
        {"host (no op recorded)": 90e-6})


def test_from_profiler_on_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch._C._profiler import _RecordFunctionFast
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function(devtrace.WINDOW):
            with _RecordFunctionFast("train.step", (), {}):
                with _RecordFunctionFast("train.forward", (), {}):
                    torch.ones(4).add_(1)
    got = spantrace.from_profiler(p)
    assert got["span_device_s"] == {} and got["unattributed_device_s"] == 0
    # no device work: the window's idle under the spans is theirs
    assert set(got["span_idle_s"]) == {"train.step", "train.forward"}


def test_span_and_counter_readers():
    train = {"kind": "train", "steps": 5, "busy_s": 1.0,
             "span_device_s": {"train.optimizer": 0.5,
                               "train.grad_norm": 0.1},
             "moe": True, "moe_choices": 4000, "moe_dropped": 100}
    assert _reader("optimizer_ms_per_step.train")(train) == pytest.approx(100)
    assert _reader("grad_norm_ms_per_step.train")(train) == pytest.approx(20)
    assert _reader("moe_drop_pct.train")(train) == pytest.approx(2.5)
    serve = {"kind": "serve", "window_s": 4.0,
             "first_token_ms": [10.0, 20.0, 30.0, 40.0, 50.0],
             "token_gap_ms": [1.0, 2.0],
             "span_idle_s": {"serve.tick": 0.2, "serve.decode_step": 0.3,
                             "serve.emit": 0.1, "serve.sleep": 1.0}}
    assert _reader("first_token_p90_ms.serve")(serve) == pytest.approx(46)
    assert _reader("token_gap_p90_ms.serve")(serve) == pytest.approx(1.9)
    assert _reader("tick_idle.serve")(serve) == pytest.approx(15.0)


@pytest.mark.parametrize("name", [
    "optimizer_ms_per_step.train", "grad_norm_ms_per_step.train",
    "moe_drop_pct.train", "first_token_p90_ms.serve",
    "token_gap_p90_ms.serve", "tick_idle.serve"])
def test_readers_find_nothing_without_the_programs_spans(name):
    """A program without spans or counters (a summary with devtrace's keys
    alone, or empty maps) reads None, in either kind of cell."""
    read = _reader(name)
    bare = {"busy_s": 1.0, "window_s": 4.0, "steps": 5, "moe": True,
            "family_s": {}, "queue_waits_ms": [1.0]}
    for kind in ("train", "serve"):
        assert read(dict(bare, kind=kind)) is None
        assert read(dict(bare, kind=kind, span_device_s={},
                         span_idle_s={}, first_token_ms=[],
                         token_gap_ms=[], moe_choices=0,
                         moe_dropped=0)) is None
