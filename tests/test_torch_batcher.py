"""PyTorch port, the dense continuous batcher of workloads/serve.py
(_Batcher) and the server around it: the batcher tests of
tests/test_serve.py run on the port, the port's greedy streams against the
JAX _Batcher's, and the HTTP responses of both servers with a batcher, on
the same tiny weights (converted from the JAX init), on the CPU."""

import http.client
import json
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.workloads import serve as jserve
from gpu_docker_api_tpu_torch import batching as tb
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.ops.quant import quantize_params
from gpu_docker_api_tpu_torch.workloads import serve as tserve

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _long(a):
    return torch.from_numpy(np.array(a)).long()


def _solo(params, cfg, prompt, n, **kw):
    return ti.generate(params, _long(prompt)[None], cfg, n, **kw)[0].tolist()


def _batcher(tiny, **kw):
    _, tcfg, _, tp = tiny
    return tserve._Batcher(tcfg, tp, **kw)


def _concurrent(b, prompts, max_new, close=True, **submit_kw):
    ex = ThreadPoolExecutor(len(prompts))
    try:
        futs = [ex.submit(b.submit, p, max_new, **submit_kw) for p in prompts]
        return [f.result(timeout=180) for f in futs]
    finally:
        if close:
            b.close()
        ex.shutdown(wait=True)


# ---- the port's streams against the JAX _Batcher's ------------------------------

STREAM_CASES = {
    "staggered, 2 slots": dict(slots=2),
    "chunked prefill, prefix cache, decode chunk": dict(
        slots=2, prefill_chunk=4, prefix_cache=2, decode_chunk=4),
    "draft model": dict(slots=2, gamma=3, draft=True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_greedy_streams_equal_the_jax_batchers(tiny, case):
    """Five requests (two sharing a 12-token prefix) into two slots, the
    later ones joining mid-decode: each stream equals the JAX _Batcher's."""
    jcfg, tcfg, jp, tp = tiny
    kw = dict(STREAM_CASES[case], max_len=64)
    draft = kw.pop("draft", False)
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        dtree = jax.tree.map(np.asarray,
                             jllama.init_params(jcfg, jax.random.key(42)))
        jkw["draft"] = (jcfg, jax.tree.map(jnp.asarray, dtree))
        tkw["draft"] = (tcfg, convert.params_from_numpy(dtree, tcfg))
    base = _prompts(30, (12,))[0]
    prompts = _prompts(31, (6, 9, 5)) + [
        np.concatenate([base, [5, 9]]).astype(np.int32),
        np.concatenate([base, [7, 1, 3]]).astype(np.int32)]
    jb = jserve._Batcher(jcfg, jp, **jkw)
    want = _concurrent(jb, [jnp.asarray(p) for p in prompts], 7)
    tb_ = tserve._Batcher(tcfg, tp, **tkw)
    assert _concurrent(tb_, [_long(p) for p in prompts], 7) == want


# ---- tests/test_serve.py's batcher tests, on the port ------------------------------

def test_continuous_batching_concurrent_requests(tiny):
    """Three concurrent greedy requests through the server's batcher (2
    slots, so one waits for a free slot) equal their solo streams."""
    _, tcfg, _, tp = tiny
    srv = tserve._Server(tcfg, tp)
    srv.batcher = tserve._Batcher(tcfg, tp, slots=2, max_len=64)
    try:
        prompts = _prompts(1, (4, 7, 10))
        ex = ThreadPoolExecutor(3)
        futs = [ex.submit(srv.generate, [p.tolist()], 5, 0.0) for p in prompts]
        got = [f.result(timeout=120)[0] for f in futs]
        ex.shutdown(wait=True)
        assert got == [_solo(tp, tcfg, p, 5) for p in prompts]
    finally:
        srv.batcher.close()


def test_batcher_rejects_overlong_request(tiny):
    b = _batcher(tiny, slots=1, max_len=16)
    try:
        with pytest.raises(ValueError, match="exceeds the batcher's max_len"):
            b.submit(torch.zeros(14, dtype=torch.long), 8)
    finally:
        b.close()


def test_batcher_crash_releases_waiters(tiny, monkeypatch):
    """A dying scheduler fails pending submits instead of hanging them;
    once it has unwound, submits fail fast."""
    b = _batcher(tiny, slots=1, max_len=32, restarts=0)

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tb, "slot_prefill", boom)
    with pytest.raises(RuntimeError, match="batcher"):
        b.submit(torch.zeros(4, dtype=torch.long), 4)
    b.thread.join(timeout=10)
    assert not b.thread.is_alive()
    with pytest.raises(RuntimeError, match="unavailable"):
        b.submit(torch.zeros(4, dtype=torch.long), 4)


def test_batcher_restarts_after_transient_crash(tiny, monkeypatch):
    """One transient device error fails the in-flight request; the
    scheduler rebuilds its cache (lengths on the device and the host) and
    serves the next request exactly."""
    _, tcfg, _, tp = tiny
    real = tb.slot_prefill
    fails = {"n": 1}

    def flaky(*a, **k):
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("transient device error")
        return real(*a, **k)

    monkeypatch.setattr(tb, "slot_prefill", flaky)
    b = _batcher(tiny, slots=1, max_len=32)
    try:
        with pytest.raises(RuntimeError, match="batcher"):
            b.submit(torch.zeros(4, dtype=torch.long), 4)
        prompt = torch.tensor([5, 9, 2, 7])
        out = None
        for _ in range(50):
            try:
                out = b.submit(prompt, 4)
                break
            except RuntimeError:
                time.sleep(0.1)
        assert out == _solo(tp, tcfg, prompt, 4)
        assert b.alive and b._restarts_left == 2
    finally:
        b.close()


def test_batcher_restart_budget_exhausts(tiny, monkeypatch):
    """A persistent fault does not retry forever: after the budget the
    batcher stays dead and submits fail fast."""
    def boom(*a, **k):
        raise RuntimeError("persistent device failure")

    monkeypatch.setattr(tb, "slot_prefill", boom)
    b = _batcher(tiny, slots=1, max_len=32, restarts=2)
    for _ in range(40):
        with pytest.raises(RuntimeError, match="batcher"):
            b.submit(torch.zeros(4, dtype=torch.long), 4)
        if not b.thread.is_alive():
            break
        time.sleep(0.05)
    b.thread.join(timeout=10)
    assert not b.thread.is_alive()
    assert not b.alive
    with pytest.raises(RuntimeError, match="unavailable"):
        b.submit(torch.zeros(4, dtype=torch.long), 4)


def test_server_batching_accepts_sampling_rejects_multirow(tiny):
    jcfg, tcfg, jp, tp = tiny
    srv = tserve._Server(tcfg, tp)
    srv.batcher = tserve._Batcher(tcfg, tp, slots=1, max_len=32)
    jsrv = jserve._Server(jcfg, jp)
    try:
        with pytest.raises(ValueError, match="continuous-batching") as e:
            srv.generate([[1, 2, 3], [4, 5, 6]], 4, temperature=0.0)
        jsrv.batcher = object()          # the JAX server's refusal, verbatim
        with pytest.raises(ValueError) as want:
            jsrv.generate([[1, 2, 3], [4, 5, 6]], 4, temperature=0.0)
        assert str(e.value) == str(want.value)
        out = srv.generate([[1, 2, 3]], 4, temperature=0.0)
        assert out == [_solo(tp, tcfg, [1, 2, 3], 4)]
        out = srv.generate([[1, 2, 3]], 4, temperature=0.9, top_k=8)
        assert len(out) == 1 and len(out[0]) == 4
        assert all(0 <= t < 256 for t in out[0])
    finally:
        srv.batcher.close()


def test_batcher_sampling_row_does_not_perturb_greedy(tiny):
    _, tcfg, _, tp = tiny
    b = _batcher(tiny, slots=2, max_len=64, seed=7)
    gp, sp = torch.tensor([5, 9, 2, 7]), torch.tensor([1, 3, 3, 8])
    ex = ThreadPoolExecutor(2)
    try:
        fg = ex.submit(b.submit, gp, 10)
        fs = ex.submit(b.submit, sp, 10, temperature=1.0, top_k=16)
        got_g, got_s = fg.result(timeout=120), fs.result(timeout=120)
    finally:
        b.close()
        ex.shutdown(wait=True)
    assert got_g == _solo(tp, tcfg, gp, 10)
    assert len(got_s) == 10 and all(0 <= t < 256 for t in got_s)


def test_batcher_sampling_deterministic_per_seed(tiny):
    prompt = torch.tensor([5, 9, 2, 7])

    def run(seed, **kw):
        b = _batcher(tiny, slots=1, max_len=32, seed=seed, **kw)
        try:
            return b.submit(prompt, 12, temperature=1.5)
        finally:
            b.close()

    a = run(11)
    assert a == run(11)                 # same seed, same stream
    assert a != run(12)
    assert run(11, decode_chunk=4) == run(11, decode_chunk=4)


def test_batcher_top_k_1_sampling_is_greedy(tiny):
    _, tcfg, _, tp = tiny
    b = _batcher(tiny, slots=2, max_len=32, decode_chunk=3)
    try:
        got = b.submit(torch.tensor([5, 9, 2, 7]), 7, temperature=1.5,
                       top_k=1)
    finally:
        b.close()
    assert got == _solo(tp, tcfg, [5, 9, 2, 7], 7)


def test_prefill_tick_round_robin_is_fair(tiny):
    """Chunked prefill rotates across slots: a parked prefill in a high
    slot is not starved by lower-index slots."""
    b = _batcher(tiny, slots=3, max_len=32, prefill_chunk=4)
    b._stop = True
    b.thread.join(timeout=10)
    assert not b.thread.is_alive()
    fed = []
    b._prefill_piece = lambda i, item, piece, first: fed.append(i)
    for i in range(3):
        b.slots[i] = {"chunks": [torch.zeros(4, dtype=torch.long)] * 8,
                      "done": threading.Event()}
    for _ in range(6):
        assert b._prefill_tick()
    assert fed == [0, 1, 2, 0, 1, 2]


def test_batcher_close_fails_fast(tiny):
    b = _batcher(tiny, slots=1, max_len=32)
    b.close()
    assert not b.thread.is_alive()
    with pytest.raises(RuntimeError, match="unavailable"):
        b.submit(torch.zeros(4, dtype=torch.long), 2)


def test_chunked_prefill_streams_exact(tiny):
    """A long prompt in 4-token pieces (the last ragged) beside a short one
    decoding: both equal their solo streams."""
    _, tcfg, _, tp = tiny
    p_long, p_short = _prompts(10, (18, 3))
    b = _batcher(tiny, slots=2, max_len=64, prefill_chunk=4)
    got = _concurrent(b, [_long(p_long), _long(p_short)], 5)
    assert got == [_solo(tp, tcfg, p_long, 5), _solo(tp, tcfg, p_short, 5)]


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_batcher_composes_with_int8_weights(tiny, mode):
    _, tcfg, _, tp = tiny
    params = quantize_params(tp, mode)
    b = tserve._Batcher(tcfg, params, slots=2, max_len=32)
    p0, p1 = _prompts(12, (6, 9))
    got = _concurrent(b, [_long(p0), _long(p1)], 4)
    assert got == [_solo(params, tcfg, p, 4) for p in (p0, p1)]


def test_batcher_rejects_empty_prompt(tiny):
    b = _batcher(tiny, slots=1, max_len=16, prefill_chunk=4)
    try:
        with pytest.raises(ValueError, match="empty"):
            b.submit(torch.zeros(0, dtype=torch.long), 4)
    finally:
        b.close()


def test_prefix_cache_reuses_kv_and_streams_exact(tiny):
    """A second request sharing a 16-token prefix restores the stored KV
    (only the suffix prefills) and still streams exactly; so does the same
    prompt again."""
    _, tcfg, _, tp = tiny
    base = _prompts(20, (16,))[0]
    p1 = _long(np.concatenate([base, [5, 9]]))
    p2 = _long(np.concatenate([base, [7, 1, 3]]))
    b = _batcher(tiny, slots=1, max_len=64, prefix_cache=4)
    try:
        got1 = b.submit(p1, 4)
        assert b.prefix_hits == 0
        got2 = b.submit(p2, 4)
        assert b.prefix_hits == 1
        got1b = b.submit(p1, 4)
        assert b.prefix_hits == 2
    finally:
        b.close()
    want1 = _solo(tp, tcfg, p1, 4)
    assert got1 == want1 and got1b == want1
    assert got2 == _solo(tp, tcfg, p2, 4)


def test_prefix_cache_survives_slot_reuse(tiny):
    """The stored prefix is a copy of the slot's KV: after other requests
    reuse the slot, a hit still serves the stored prompt's stream."""
    _, tcfg, _, tp = tiny
    base, other = _prompts(21, (20, 20))
    p1 = _long(np.concatenate([base, [3]]))
    b = _batcher(tiny, slots=1, max_len=64, prefix_cache=4)
    try:
        b.submit(_long(base), 3)
        b.submit(_long(other), 3)             # overwrites the slot's row
        got = b.submit(p1, 5)
        assert b.prefix_hits >= 1
    finally:
        b.close()
    assert got == _solo(tp, tcfg, p1, 5)


def test_prefix_cache_composes_with_chunked_prefill(tiny):
    _, tcfg, _, tp = tiny
    base = _prompts(22, (12,))[0]
    p1 = _long(np.concatenate([base, [2]]))
    p2 = _long(np.concatenate([base, [8, 4, 6, 1, 9]]))
    b = _batcher(tiny, slots=2, max_len=64, prefill_chunk=4, prefix_cache=2)
    try:
        b.submit(p1, 2)
        got2 = b.submit(p2, 5)
        assert b.prefix_hits == 1
    finally:
        b.close()
    assert got2 == _solo(tp, tcfg, p2, 5)


def test_prefix_cache_lru_eviction(tiny):
    b = _batcher(tiny, slots=1, max_len=64, prefix_cache=2)
    try:
        for p in _prompts(23, (10, 10, 10, 10)):
            b.submit(_long(p), 2)
        assert len(b._prefixes) == 2              # LRU-bounded
    finally:
        b.close()


SUBMIT_CASES = [
    dict(temperature=1.0, top_p=0.0),
    dict(temperature=1.0, top_p=1e-46),   # rounds to 0.0f
    dict(temperature=-1.0),
    dict(temperature=float("nan")),
    dict(top_k=-3),
]


def test_batcher_submit_validates_like_jax(tiny):
    """Each refused submit raises the JAX _Batcher's ValueError message; a
    huge top_k means "no filter" and is served."""
    jcfg, _, jp, _ = tiny
    ours = _batcher(tiny, slots=1, max_len=32)
    theirs = jserve._Batcher(jcfg, jp, slots=1, max_len=32)
    try:
        cases = [(torch.zeros(4, dtype=torch.long), 4, kw)
                 for kw in SUBMIT_CASES]
        cases += [(torch.zeros(0, dtype=torch.long), 4, {}),
                  (torch.zeros(30, dtype=torch.long), 8, {})]
        for prompt, max_new, kw in cases:
            with pytest.raises(ValueError) as got:
                ours.submit(prompt, max_new, **kw)
            with pytest.raises(ValueError) as want:
                theirs.submit(jnp.asarray(prompt.numpy(), jnp.int32), max_new,
                              **kw)
            assert str(got.value) == str(want.value), kw
        out = ours.submit(torch.zeros(4, dtype=torch.long), 2,
                          temperature=0.5, top_k=2 ** 31)
        assert len(out) == 2
    finally:
        ours.close()
        theirs.close()


def test_lengths_stay_in_step_with_the_host(tiny):
    """After a mixed run (chunked prefill, a prefix hit, decode chunks, a
    draft's rollbacks) the device lengths equal the host mirror in both
    caches."""
    _, tcfg, _, tp = tiny
    draft = tllama.init_params(tcfg, torch.Generator().manual_seed(3))
    base = _prompts(24, (14,))[0]
    prompts = [_long(np.concatenate([base, [i]])) for i in range(3)]
    for kw in (dict(prefill_chunk=4, prefix_cache=2, decode_chunk=3),
               dict(prefill_chunk=5, draft=(tcfg, draft), gamma=2)):
        b = _batcher(tiny, slots=2, max_len=64, **kw)
        _concurrent(b, prompts, 6, close=False)
        caches = [b.cache] + ([b.d_cache] if "draft" in kw else [])
        b.close()
        for cache in caches:
            assert cache["lengths"].tolist() == cache["host_lengths"]


# ---- the server with a batcher, against the JAX server's -------------------------

def _start(srv, handler_for, **kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                handler_for(srv, "llama/tiny", **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _raw(port, method, path, body=None, headers=None):
    """(status, version, headers without Date, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        hdrs = [(k, v) for k, v in resp.getheaders() if k != "Date"]
        return resp.status, resp.version, hdrs, resp.read()
    finally:
        conn.close()


CLOCK_HEADERS = ("X-TDAPI-Queue-Wait-EWMA-Ms", "X-TDAPI-Queue-Wait-Ms")
# the port's own per-request clocks, which the JAX server does not send
PORT_CLOCK_HEADERS = ("X-TDAPI-First-Token-Ms", "X-TDAPI-Token-Gap-Ms")


def _without_port_clocks(resp):
    """The response without the port's own clock headers, each checked to
    be a time in ms."""
    status, version, hdrs, body = resp
    for k, v in hdrs:
        if k in PORT_CLOCK_HEADERS:
            assert float(v) >= 0, (k, v)
    return (status, version,
            [(k, v) for k, v in hdrs if k not in PORT_CLOCK_HEADERS], body)


def _clockless(resp):
    """The response with its clock-dependent values (the queue-wait
    headers, healthz's queueWait ms) replaced by their type names; where
    the body held such values its Content-Length goes too (their digits
    vary), after a check that it is the body's length."""
    status, version, hdrs, body = resp
    qw = None
    if b'"queueWait"' in body:
        data = json.loads(body)
        qw = data["data"]["batching"]["queueWait"]
        for key in ("totalMs", "lastMs", "ewmaMs"):
            qw[key] = type(qw[key]).__name__
        body = json.dumps(data).encode()
    out = []
    for k, v in hdrs:
        if k in CLOCK_HEADERS:
            v = type(float(v)).__name__
        elif k == "Content-Length" and qw is not None:
            assert int(v) == len(resp[3])
            v = "n"
        out.append((k, v))
    return status, version, out, body


@pytest.fixture(scope="module")
def batching_servers(tiny):
    """(port server's port, JAX server's port), both with --batch-slots 2
    at the model's max_seq_len."""
    jcfg, tcfg, jp, tp = tiny
    ours = tserve._Server(tcfg, tp)
    ours.batcher = tserve._Batcher(tcfg, tp, slots=2, max_len=128)
    theirs = jserve._Server(jcfg, jp)
    theirs.batcher = jserve._Batcher(jcfg, jp, slots=2, max_len=128)
    httpds = [_start(ours, tserve._handler_for),
              _start(theirs, jserve._handler_for)]
    yield httpds[0].server_address[1], httpds[1].server_address[1]
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    ours.batcher.close()
    theirs.batcher.close()


ONE = [[5, 9, 2, 7]]
REQUESTS = {
    "healthz": ("GET", "/healthz", None),
    "greedy": ("POST", "/generate", {"tokens": ONE, "max_new": 6}),
    "default max_new": ("POST", "/generate", {"tokens": ONE}),
    "top_k 1 at 1.5": ("POST", "/generate", {"tokens": ONE, "max_new": 5,
                                             "temperature": 1.5, "top_k": 1,
                                             "top_p": 0.93}),
    "two rows": ("POST", "/generate", {"tokens": [[5, 9], [2, 7]],
                                       "max_new": 2}),
    "past max_len": ("POST", "/generate", {"tokens": ONE, "max_new": 200}),
    "max_new 0": ("POST", "/generate", {"tokens": ONE, "max_new": 0}),
    "no tokens": ("POST", "/generate", {}),
    "token out of range": ("POST", "/generate", {"tokens": [[99999]]}),
    "top_p 0": ("POST", "/generate", {"tokens": ONE, "top_p": 0.0}),
    "temperature 99": ("POST", "/generate", {"tokens": ONE,
                                             "temperature": 99.0}),
    "POST /nope": ("POST", "/nope", {}),
    "GET /kv": ("GET", "/kv?key=abc", None),
    "traceparent": ("POST", "/generate", {"tokens": ONE, "max_new": 2}),
}
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_batching_responses_are_the_jax_servers(batching_servers, name):
    """Each request, sent in turn to both servers with a batcher: status
    line, headers (Date aside) and body byte for byte, except the
    clock-dependent queue-wait values, compared by name and type, and the
    port's own first-token and token-gap headers, which the JAX server
    does not send."""
    ours, theirs = batching_servers
    method, path, body = REQUESTS[name]
    hdrs = {"traceparent": TRACEPARENT} if name == "traceparent" else None
    got = _raw(ours, method, path, body, hdrs)
    want = _raw(theirs, method, path, body, hdrs)
    assert _clockless(_without_port_clocks(got)) == _clockless(want)
    assert {"X-TDAPI-Slots", "X-TDAPI-Active", "X-TDAPI-Queued"} <= {
        k for k, _ in got[2]}


def test_batching_healthz_counts_admissions(batching_servers):
    ours, theirs = batching_servers
    before = json.loads(_raw(ours, "GET", "/healthz")[3])["data"]["batching"]
    status, _, hdrs, body = _raw(ours, "POST", "/generate",
                                 {"tokens": ONE, "max_new": 3})
    # the JAX server takes the same request: the two histories stay equal
    _raw(theirs, "POST", "/generate", {"tokens": ONE, "max_new": 3})
    out = json.loads(body)
    assert status == 200 and out["code"] == 200
    assert float(dict(hdrs)["X-TDAPI-Queue-Wait-Ms"]) >= 0
    after = json.loads(_raw(ours, "GET", "/healthz")[3])["data"]["batching"]
    assert after["queueWait"]["count"] == before["queueWait"]["count"] + 1
    assert after["slots"] == 2 and after["alive"] is True
    assert after["active"] == 0 and after["queued"] == 0


def test_admit_queue_sheds_with_the_jax_servers_429(tiny):
    """--admit-queue 1 with one request waiting: both servers shed the
    next /generate with the same 429 envelope, Retry-After and
    X-TDAPI-Shed, before it reaches the batcher."""
    jcfg, tcfg, jp, tp = tiny
    ours = tserve._Server(tcfg, tp)
    ours.batcher = tserve._Batcher(tcfg, tp, slots=1, max_len=32)
    theirs = jserve._Server(jcfg, jp)
    theirs.batcher = jserve._Batcher(jcfg, jp, slots=1, max_len=32)
    httpds = []
    try:
        for srv in (ours, theirs):
            # a stopped scheduler with one item parked in its queue
            srv.batcher._stop = True
            srv.batcher.thread.join(timeout=10)
            srv.batcher.queue.put({"done": threading.Event()})
        httpds = [_start(ours, tserve._handler_for, admit_queue=1),
                  _start(theirs, jserve._handler_for, admit_queue=1)]
        got, want = (_raw(h.server_address[1], "POST", "/generate",
                          {"tokens": ONE}) for h in httpds)
        assert got == want
        assert got[0] == 200                 # the envelope carries the 429
        assert json.loads(got[3]) == {"code": 429, "msg": "replica queue full",
                                      "data": None}
        hdrs = dict(got[2])
        assert hdrs["Retry-After"] == "1" and hdrs["X-TDAPI-Shed"] == "1"
        assert hdrs["X-TDAPI-Queued"] == "1"
    finally:
        for httpd in httpds:
            httpd.shutdown()
            httpd.server_close()
        ours.batcher.close()
        theirs.batcher.close()


def test_sampling_parameters_are_bucketed_only_without_a_batcher(tiny):
    """Without a batcher the handler rounds temperature and top_p to 1/20
    and caps top_k at 128, as the JAX server does; a batcher gets them as
    sent."""
    _, tcfg, _, tp = tiny
    seen = []

    class Recording(tserve._Server):
        def generate(self, tokens, max_new, temperature, top_k=0, top_p=1.0,
                     stats_out=None):
            seen.append((temperature, top_k, top_p))
            return [[0]]

    body = {"tokens": ONE, "temperature": 0.73, "top_k": 300, "top_p": 0.93}
    # the response headers read a batcher's slots and queue: a stand-in
    stand_in = types.SimpleNamespace(slots=[None], queued=0,
                                     queue_wait_ewma_ms=None, _trie=None,
                                     _paged=False)
    for batcher in (None, stand_in):
        srv = Recording(tcfg, tp)
        srv.batcher = batcher
        httpd = _start(srv, tserve._handler_for)
        try:
            assert _raw(httpd.server_address[1], "POST", "/generate",
                        body)[0] == 200
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert seen == [(0.75, 128, 0.95), (0.73, 300, 0.93)]
