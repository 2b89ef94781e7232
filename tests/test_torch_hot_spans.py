"""PyTorch port: the hot-path spans inside Trainer.step and the batcher's
tick (obs/trace.hot mirrored into torch.profiler ranges), the batcher's
first-token and token-gap headers, and the MoE drop counter, on the CPU at
a tiny size."""

import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe
from gpu_docker_api_tpu_torch.obs import trace
from gpu_docker_api_tpu_torch.workloads import serve as tserve

torch.set_num_threads(1)

TICK_CHILDREN = {"serve.admit", "serve.prefill_piece", "serve.first_token",
                 "serve.decode_step", "serve.emit"}


@pytest.fixture
def armed():
    trace.arm_hot(True)
    yield
    trace.arm_hot(False)


def _spans(prof, prefix):
    """[(name, start, end, kwinputs)] of the profiler's ranges named
    prefix*, by start (the parent first where two start together)."""
    out = [(e.name, e.time_range.start, e.time_range.end, e.kwinputs)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _trainer(accum=1):
    cfg = tllama.LlamaConfig.tiny()
    tc = ttrain.TrainConfig(accum_steps=accum, remat=False)
    trainer = ttrain.Trainer.create(cfg, tc=tc, device="cpu")
    return trainer, trainer.init(seed=0)


def _tokens(b=2, s=16):
    return torch.randint(0, 256, (b, s),
                         generator=torch.Generator().manual_seed(0))


def test_hot_is_a_shared_no_op_until_armed():
    assert trace.hot("train.step", step=1) is trace.NO_SPAN
    with trace.hot("serve.tick") as s:
        assert s is None
    opened = []
    trace.arm_hot(True)
    try:
        # armed, with no profiler running, the mirror opens nothing
        assert trace.hot("train.step") is trace.NO_SPAN
        with profile(activities=[ProfilerActivity.CPU]):
            span = trace.hot("train.step", step=2)
            opened.append(span)
            with span:
                pass
    finally:
        trace.arm_hot(False)
    assert opened[0] is not trace.NO_SPAN
    assert trace.hot("train.step") is trace.NO_SPAN


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_step_spans_nest_in_order(armed, accum):
    trainer, state = _trainer(accum)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        trainer.step(state, _tokens(b=2))
    spans = _spans(p, "train.")
    step = [s for s in spans if s[0] == "train.step"]
    assert len(step) == 1 and step[0][3].get("step") == 0
    inner = [s for s in spans if s[0] != "train.step"]
    assert all(_inside(s, step[0]) for s in inner)
    names = [s[0] for s in inner]
    assert names == (["train.forward", "train.backward"] * accum
                     + ["train.grad_norm", "train.optimizer"])
    # consecutive, not nested in one another
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    if accum > 1:
        assert [s[3].get("micro") for s in inner[:4]] == [0, 0, 1, 1]


def _stopped_batcher(**kw):
    """A tiny batcher whose scheduler thread has left: the test's thread
    ticks it, under the test's profiler."""
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    b = tserve._Batcher(cfg, params, **kw)
    b._stop = True
    b.thread.join(timeout=10)
    assert not b.thread.is_alive()
    b._stop = False
    return b


def _serve_ticks(b, prompts, max_new, prof_kw=None):
    """Submit every prompt from threads, tick on this thread until all are
    answered. -> (streams, stats_out dicts, profiler)."""
    stats = [{} for _ in prompts]
    ex = ThreadPoolExecutor(len(prompts))
    futs = []
    for p, st in zip(prompts, stats):
        n = b.queue.qsize()
        futs.append(ex.submit(b.submit, torch.tensor(p), max_new,
                              stats_out=st))
        while b.queue.qsize() == n:         # submitted in this order
            pass
    with profile(activities=[ProfilerActivity.CPU],
                 **(prof_kw or {})) as prof:
        with torch.no_grad():
            for _ in range(200):
                if all(f.done() for f in futs):
                    break
                b._tick()
    out = [f.result(timeout=60) for f in futs]
    ex.shutdown()
    return out, stats, prof


def test_batcher_tick_spans_carry_request_ids(armed):
    b = _stopped_batcher(slots=2, max_len=64, prefill_chunk=4)
    prompts = [[5, 9, 2, 7, 1, 3], [4, 4, 8]]
    _, _, p = _serve_ticks(b, prompts, 3, {"record_shapes": True})
    spans = _spans(p, "serve.")
    ticks = [s for s in spans if s[0] == "serve.tick"]
    inner = [s for s in spans if s[0] != "serve.tick"]
    assert ticks and {s[0] for s in inner} == TICK_CHILDREN
    assert all(any(_inside(s, t) for t in ticks) for s in inner)
    pieces = [s for s in inner if s[0] == "serve.prefill_piece"]
    # the first prompt in two pieces (4 + 2), the second in one
    assert sorted((s[3]["rid"], s[3]["tokens"]) for s in pieces) == [
        (0, 2), (0, 4), (1, 3)]
    firsts = [s[3]["rid"] for s in inner if s[0] == "serve.first_token"]
    assert sorted(firsts) == [0, 1]
    steps = [s[3] for s in inner if s[0] == "serve.decode_step"]
    assert {"0,1"} <= {st["ids"] for st in steps}
    assert all(len(st["ids"].split(",")) == st["rows"] for st in steps)
    # a prefill piece and the first token run inside a tick's work, not
    # inside a decode step
    for s in pieces:
        assert not any(_inside(s, d) for d in inner
                       if d[0] == "serve.decode_step")
    b.close()


def test_idle_loop_sleeps_in_its_own_span(armed):
    b = _stopped_batcher(slots=1, max_len=32)
    calls = []
    b._sync = lambda: 0 if calls.append(1) or len(calls) > 3 else 1
    with profile(activities=[ProfilerActivity.CPU]) as p:
        b._loop()
    spans = _spans(p, "serve.")
    assert [s[0] for s in spans].count("serve.sleep") == 3
    assert [s[0] for s in spans].count("serve.tick") == 3
    sleeps = [s for s in spans if s[0] == "serve.sleep"]
    ticks = [s for s in spans if s[0] == "serve.tick"]
    assert not any(_inside(s, t) for s in sleeps for t in ticks)
    b.close()


def test_disarmed_spans_open_no_profiler_range():
    trainer, state = _trainer()
    b = _stopped_batcher(slots=1, max_len=32)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        trainer.step(state, _tokens())
    _, _, q = _serve_ticks(b, [[5, 9, 2]], 2)
    b.close()
    assert _spans(p, "train.") == []
    assert _spans(q, "serve.") == []
    assert any(e.name.startswith("aten::") for e in q.events())


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def test_first_token_and_token_gap_headers():
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    srv = tserve._Server(cfg, params)
    srv.batcher = tserve._Batcher(cfg, params, slots=2, max_len=64,
                                  prefill_chunk=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserve._handler_for(srv, "llama/tiny"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        for max_new in (6, 1):
            hdrs, body = _post(port, {"tokens": [[5, 9, 2, 7, 1, 3]],
                                      "max_new": max_new})
            assert body["code"] == 200
            assert len(body["data"]["tokens"][0]) == max_new
            wait = float(hdrs["X-TDAPI-Queue-Wait-Ms"])
            first = float(hdrs["X-TDAPI-First-Token-Ms"])
            assert 0 <= wait <= first
            if max_new > 1:
                assert float(hdrs["X-TDAPI-Token-Gap-Ms"]) >= 0
            else:
                assert "X-TDAPI-Token-Gap-Ms" not in hdrs
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.batcher.close()


def test_stats_out_orders_wait_first_token_and_gap():
    b = _stopped_batcher(slots=2, max_len=64, prefill_chunk=2)
    streams, stats, _ = _serve_ticks(b, [[5, 9, 2, 7, 1], [3, 3]], 4)
    b.close()
    for out, st in zip(streams, stats):
        assert len(out) == 4
        assert st["queueWaitMs"] <= st["firstTokenMs"]
        assert st["tokenGapMs"] >= 0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_drop_counter_equals_a_plain_count(remat, monkeypatch):
    """Forced over capacity (capacity factor 0.5): the counter armed over
    one loss and its backward equals the plain count of ~keep over the
    layers of one forward, under remat's recompute too."""
    import dataclasses
    cfg = dataclasses.replace(moe.MoEConfig.tiny(), capacity_factor=0.5)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = _tokens(b=2, s=16)

    keeps = []
    route = moe._route

    def recording(*a, **k):
        out = route(*a, **k)
        keeps.append(out[6])
        return out
    monkeypatch.setattr(moe, "_route", recording)
    with torch.no_grad():
        moe.moe_forward(params, tokens, cfg)
    monkeypatch.setattr(moe, "_route", route)
    assert len(keeps) == cfg.n_layers
    plain = sum(int((~k).sum()) for k in keeps)
    choices = sum(k.numel() for k in keeps)
    assert plain > 0

    leaves = ttrain.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    moe.reset_drops()
    moe.count_drops(True)
    try:
        loss = ttrain.loss_fn(params, tokens, cfg, remat=remat != "none",
                              remat_policy=remat if remat != "none"
                              else "dots")
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        moe.count_drops(False)
    assert moe.read_drops() == {"choices": choices, "dropped": plain}
    moe.reset_drops()
    assert moe.read_drops() == {"choices": 0, "dropped": 0}
