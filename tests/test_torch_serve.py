"""PyTorch port, workloads/serve.py: the single-host server's HTTP contract
against the JAX server's, both serving the same tiny weights (converted
from the JAX init) on ephemeral ports in this process, on the CPU."""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.ops import quant as jquant
from gpu_docker_api_tpu.workloads import serve as jserve
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.ops import quant as tquant
from gpu_docker_api_tpu_torch.train import tree_leaves
from gpu_docker_api_tpu_torch.workloads import serve as tserve

torch.set_num_threads(1)

PROMPT = [[5, 9, 2, 7], [1, 3, 3, 8]]


def _start(srv, handler_for):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_for(srv, "llama/tiny"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def servers():
    """(port params, port server's port, JAX server's port)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    params = convert.params_from_numpy(tree, tcfg)
    ours = _start(tserve._Server(tcfg, params), tserve._handler_for)
    theirs = _start(jserve._Server(jcfg, jax.tree.map(jnp.asarray, tree)),
                    jserve._handler_for)
    yield params, ours.server_address[1], theirs.server_address[1]
    for httpd in (ours, theirs):
        httpd.shutdown()
        httpd.server_close()


def _raw(port, method, path, body=None, headers=None):
    """(status, headers without Date, body bytes) of one request."""
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


def _call(port, method, path, body=None):
    return json.loads(_raw(port, method, path, body)[3])


REQUESTS = {
    "healthz": ("GET", "/healthz", None),
    "greedy": ("POST", "/generate", {"tokens": PROMPT, "max_new": 6,
                                     "temperature": 0.0}),
    "default max_new": ("POST", "/generate", {"tokens": [[5, 9, 2, 7]]}),
    "top_k 1 at 1.5": ("POST", "/generate", {"tokens": [[5, 9, 2, 7]],
                                             "max_new": 5, "temperature": 1.5,
                                             "top_k": 1, "top_p": 0.9}),
    "no tokens": ("POST", "/generate", {}),
    "token out of range": ("POST", "/generate", {"tokens": [[99999]],
                                                 "max_new": 2}),
    "negative token": ("POST", "/generate", {"tokens": [[-1, 2]]}),
    "not a batch": ("POST", "/generate", {"tokens": [1, 2]}),
    "max_new 0": ("POST", "/generate", {"tokens": [[1, 2]], "max_new": 0}),
    "max_new not a number": ("POST", "/generate", {"tokens": [[1, 2]],
                                                   "max_new": "x"}),
    "top_p 0": ("POST", "/generate", {"tokens": [[1, 2]], "top_p": 0.0}),
    "top_p 1.5": ("POST", "/generate", {"tokens": [[1, 2]], "top_p": 1.5}),
    "top_k -1": ("POST", "/generate", {"tokens": [[1, 2]], "top_k": -1}),
    "temperature -1": ("POST", "/generate", {"tokens": [[1, 2]],
                                             "temperature": -1.0}),
    "temperature 99": ("POST", "/generate", {"tokens": [[1, 2]],
                                             "temperature": 99.0}),
    "POST /nope": ("POST", "/nope", {}),
    "GET /nope": ("GET", "/nope", None),
    "GET /kv": ("GET", "/kv?key=abc", None),
    "GET /kv bare": ("GET", "/kv", None),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_responses_are_the_jax_servers_byte_for_byte(servers, name):
    """Status line, headers (Date aside) and body of each request equal the
    JAX server's: the envelope, the codes, the messages, the tokens."""
    _, ours, theirs = servers
    method, path, body = REQUESTS[name]
    got = _raw(ours, method, path, body)
    want = _raw(theirs, method, path, body)
    assert got == want
    assert got[0] == 200 and got[1] == 11            # HTTP/1.1, envelope


def test_healthz_fields(servers):
    params, ours, _ = servers
    out = _call(ours, "GET", "/healthz")
    cfg = tllama.LlamaConfig.tiny()
    assert out == {"code": 200, "msg": "Success", "data": {
        "model": "llama/tiny",
        "params": sum(t.numel() for t in tree_leaves(params)),
        "vocab": cfg.vocab_size, "maxSeqLen": cfg.max_seq_len}}


def test_greedy_over_http_equals_generate(servers):
    params, ours, _ = servers
    out = _call(ours, "POST", "/generate", {"tokens": PROMPT, "max_new": 6})
    assert out["code"] == 200, out
    want = ti.generate(params, torch.tensor(PROMPT), tllama.LlamaConfig.tiny(),
                       6)
    assert out["data"]["tokens"] == want.tolist()


@pytest.mark.parametrize("case, code", [
    ({"tokens": [[1, 2]], "max_new": 0}, 400),
    ({"tokens": [[1, 2]], "top_p": 0.0}, 400),
    ({"tokens": [[1, 2]], "top_k": -1}, 400),
    ({"tokens": [[1, 2]], "temperature": 10.5}, 400),
    ({"tokens": [[]]}, 400),
    ({"tokens": [[1, 2], [3]]}, 400),
    ({"tokens": [[2 ** 70]]}, 400),
    ({"tokens": "abc"}, 400),
    ({"tokens": [[1, 2]], "max_new": 3, "temperature": 0.7, "top_k": 300,
      "top_p": 0.93}, 200),
])
def test_validation_codes(servers, case, code):
    _, ours, _ = servers
    out = _call(ours, "POST", "/generate", case)
    assert out["code"] == code, out
    if code == 400:
        assert out["msg"].startswith("bad request: ") and out["data"] is None
    else:
        toks = out["data"]["tokens"]
        assert len(toks) == 1 and len(toks[0]) == 3
        assert all(0 <= x < 256 for x in toks[0])


def test_traceparent_is_echoed(servers):
    _, ours, _ = servers
    tp = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    for method, path, body in (("GET", "/healthz", None),
                               ("POST", "/generate", {"tokens": [[1, 2]],
                                                      "max_new": 1}),
                               ("GET", "/nope", None)):
        _, _, hdrs, _ = _raw(ours, method, path, body,
                             headers={"traceparent": tp})
        assert dict(hdrs).get("traceparent") == tp
    assert "traceparent" not in dict(_raw(ours, "GET", "/healthz")[2])


def test_speculative_server_streams_the_greedy_tokens():
    jcfg, cfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0))),
        cfg)
    draft = convert.params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(1))),
        cfg)
    srv = tserve._Server(cfg, params, draft=(cfg, draft), gamma=3)
    got = srv.generate([[5, 9, 2, 7]], 9, 0.0)
    assert got == ti.generate(params, torch.tensor([[5, 9, 2, 7]]), cfg,
                              9).tolist()
    # two rows go through plain generate
    assert srv.generate(PROMPT, 4, 0.0) == ti.generate(
        params, torch.tensor(PROMPT), cfg, 4).tolist()


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_parameter_count_matches_jax(mode):
    jcfg, cfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), mode)
    tq = tquant.quantize_params(convert.params_from_numpy(tree, cfg), mode)
    assert (tserve._Server(cfg, tq).n_params
            == jserve._Server(jcfg, jq).n_params)


BASE = ["--device", "cpu", "--config", "tiny", "--port", "1"]


@pytest.mark.parametrize("extra, env, message", [
    (["--batch-slots", "2"], {"TDAPI_TPU_SHARES": "2"},
     "co-tenancy regulator is not yet ported"),
    (["--batch-slots", "2"], {"TDAPI_PRIORITY": "latency"},
     "co-tenancy regulator is not yet ported"),
    ([], {"TPU_WORKER_HOSTNAMES": "w0,w1"}, "not yet ported"),
    # refused by the JAX server too: its messages
    (["--prefix-cache", "8"], {}, "needs --batch-slots N"),
    (["--kv-block", "16"], {}, "need --batch-slots N"),
    (["--kv-pool", "64"], {}, "need --batch-slots N"),
    (["--host-load"], {}, "requires --quantize"),
    (["--shard-kv"], {}, "no mesh to shard over"),
])
def test_not_yet_ported_flags_are_refused(monkeypatch, extra, env, message):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=message):
        tserve.main(BASE + extra)


class _NoHTTP:
    """Stands in for ThreadingHTTPServer: binds nothing, serves nothing."""

    def __init__(self, address, handler):
        self.server_address = address

    def serve_forever(self):
        pass

    def server_close(self):
        pass


@pytest.mark.parametrize("extra, want", [
    (["--batch-slots", "4"], dict(slots=4, max_len=128)),
    (["--batch-slots", "2", "--batch-max-len", "64"],
     dict(slots=2, max_len=64)),
    (["--batch-slots", "2", "--batch-prefill-chunk", "8"],
     dict(prefill_chunk=8)),
    (["--batch-slots", "2", "--decode-chunk", "4"], dict(decode_chunk=4)),
    (["--batch-slots", "2", "--admit-queue", "2"], dict(slots=2)),
    (["--batch-slots", "4", "--prefix-cache", "8"], dict(prefix_cache=8)),
    (["--batch-slots", "2", "--kv-quant"], dict(kv_quant=True)),
    (["--batch-slots", "2", "--draft-config", "tiny", "--gamma", "3"],
     dict(gamma=3)),
    # without --batch-slots the JAX server ignores them too: no batcher
    (["--batch-max-len", "64"], None),
    (["--batch-prefill-chunk", "8"], None),
    (["--decode-chunk", "4"], None),
    (["--admit-queue", "2"], None),
])
def test_batcher_flags_start_a_batcher(monkeypatch, capsys, extra, want):
    """The batcher's flags are accepted: with --batch-slots main starts a
    dense _Batcher configured by them (the HTTP server stood in for),
    prints the JAX server's line, and closes it on the way out."""
    made = []

    class Recorded(tserve._Batcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "ThreadingHTTPServer", _NoHTTP)
    monkeypatch.setattr(tserve, "_Batcher", Recorded)
    assert tserve.main(BASE + extra) == 0
    out = capsys.readouterr().out
    if want is None:
        assert made == [] and "continuous batching" not in out
        return
    (b,) = made
    got = dict(vars(b), slots=len(b.slots))
    assert {name: got[name] for name in want} == want
    spec = ", speculative (draft tiny, gamma 3)" if "--gamma" in extra else ""
    assert (f"continuous batching: {len(b.slots)} slots x {b.max_len} tokens, "
            f"dense KV{spec}\n") in out
    assert not b.thread.is_alive() and not b.alive


class _OneHealthz(_NoHTTP):
    """Stands in for ThreadingHTTPServer: serves the handler main built on
    a free local port for one GET /healthz, recorded in HEALTH, then
    returns."""
    HEALTH = []

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self.handler = handler

    def serve_forever(self):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            _, _, _, body = _raw(httpd.server_address[1], "GET", "/healthz")
            self.HEALTH.append(json.loads(body)["data"])
        finally:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("extra, want", [
    (["--batch-slots", "4", "--kv-block", "16"],
     {"blockSize": 16, "poolBlocks": 1 + 4 * 8, "freeBlocks": 4 * 8}),
    (["--batch-slots", "4", "--kv-pool", "64", "--kv-block", "8"],
     {"blockSize": 8, "poolBlocks": 64, "freeBlocks": 63}),
    # single-host serving ignores --tp, as the JAX server does
    (["--tp", "2"], None),
])
def test_paged_and_tp_flags_start_a_server(monkeypatch, capsys, extra, want):
    """--kv-block / --kv-pool with --batch-slots start a paged batcher whose
    healthz has the `paged` block and print the JAX server's paged line;
    --tp 2 starts a server."""
    _OneHealthz.HEALTH.clear()
    monkeypatch.setattr(tserve, "ThreadingHTTPServer", _OneHealthz)
    assert tserve.main(BASE + extra) == 0
    (health,) = _OneHealthz.HEALTH
    out = capsys.readouterr().out
    assert "serving llama/tiny" in out
    if want is None:
        assert "batching" not in health
        return
    assert health["batching"]["paged"] == want
    assert (f"continuous batching: 4 slots x 128 tokens, paged "
            f"({want['poolBlocks']} x {want['blockSize']} token blocks) KV"
            in out)


def test_kv_block_without_device_cpu_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--config", "tiny", "--port", "1", "--batch-slots", "4",
                     "--kv-block", "16", "--prefix-cache", "4"])


def test_batch_slots_without_device_cpu_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--config", "tiny", "--port", "1", "--batch-slots", "4"])


def test_draft_with_another_vocab_is_refused(monkeypatch):
    from gpu_docker_api_tpu_torch import models
    monkeypatch.setitem(models.NAMED_CONFIGS["llama"], "other_vocab",
                        lambda: tllama.LlamaConfig(
                            vocab_size=512, d_model=32, n_layers=1, n_heads=2,
                            n_kv_heads=1, d_ff=64, max_seq_len=64,
                            dtype=torch.float32))
    with pytest.raises(SystemExit, match="share a vocab"):
        tserve.main(BASE + ["--draft-config", "other_vocab"])


def test_main_without_device_cpu_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--config", "tiny", "--port", "1"])


def test_served_weights_carry_no_autograd(tmp_path):
    """A checkpoint of the torch trainer restores with requires_grad leaves;
    the server detaches them once."""
    from gpu_docker_api_tpu_torch.train import Trainer, save_checkpoint
    cfg = tllama.LlamaConfig.tiny()
    trainer = Trainer.create(cfg, device="cpu")
    state = trainer.init(seed=3)
    save_checkpoint(str(tmp_path), state, 2)
    params = tserve._load_params(trainer, str(tmp_path))
    for t in tree_leaves(params):
        assert not t.requires_grad
    for name, t in params["layers"].items():
        assert torch.equal(t, state["params"]["layers"][name].detach())
    fresh = tserve._load_params(trainer, "")
    assert torch.equal(fresh["embed"], Trainer.create(
        cfg, device="cpu").init(0)["params"]["embed"].detach())
