"""PyTorch port, the KV handoff of prefill/decode disaggregation and the
KV-affinity sketch (workloads/serve.py with a paged batcher): each
package's HTTP handler around a paged tiny batcher in an in-process
ThreadingHTTPServer, fed the same requests; the sketch headers, the healthz
blocks and the /kv exports against the JAX server's; a handoff from a JAX
prefill replica to a port decode replica and back; the fall-backs to a full
prefill; and the serve command itself, on the CPU."""

import base64
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.workloads import serve as jserve
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.workloads import serve as tserve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the KV exports of the two packages: f32 values agree up to summation
# order (the tolerance of tests/test_torch_batching.py)
TOL = dict(rtol=1e-5, atol=1e-5)
PAGED = dict(slots=2, max_len=96, kv_block=4)


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _solo(tiny, prompt, n):
    _, tcfg, _, tp_ = tiny
    return ti.generate(tp_, torch.tensor([prompt]), tcfg, n)[0].tolist()


class _Replica:
    """A package's _Server with a paged batcher behind its HTTP handler on a
    free local port."""

    def __init__(self, tiny, package, **kw):
        jcfg, tcfg, jp_, tp_ = tiny
        serve, cfg, params = ((jserve, jcfg, jp_) if package == "jax"
                              else (tserve, tcfg, tp_))
        self.srv = serve._Server(cfg, params)
        self.srv.batcher = serve._Batcher(cfg, params, **{**PAGED, **kw})
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), serve._handler_for(self.srv, "llama/tiny"))
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.batcher.close()


def _raw(port, method, path, body=None, headers=None):
    """(headers dict, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        assert resp.status == 200
        return dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _generate(port, row, max_new, headers=None):
    hdrs, body = _raw(port, "POST", "/generate",
                      {"tokens": [row], "max_new": max_new}, headers)
    out = json.loads(body)
    assert out["code"] == 200, out
    return out["data"]["tokens"][0], hdrs


def _health(port):
    return json.loads(_raw(port, "GET", "/healthz")[1])["data"]["batching"]


@pytest.fixture()
def pair(tiny):
    """(port replica, JAX replica), paged with the prefix trie."""
    reps = [_Replica(tiny, "port", prefix_cache=4),
            _Replica(tiny, "jax", prefix_cache=4)]
    yield reps
    for r in reps:
        r.close()


# ---- the sketch and healthz against the JAX server's ---------------------------

def test_sketch_headers_and_healthz_blocks_equal_the_jax_servers(pair):
    """The same requests (prompts sharing 32- and 64-token prefixes, so the
    sketch sets bits) to both servers: every response's X-TDAPI-KV-Sketch
    and -Occ, then healthz's prefixCache and paged blocks, are equal."""
    ours, theirs = pair
    base = _prompts(1, (64,))[0]
    rows = [base[:40], base + [3, 9], base[:32] + _prompts(2, (20,))[0],
            _prompts(3, (70,))[0], base + [3, 9, 1]]
    seen = []
    for row in rows:
        got, want = (_generate(r.port, row, 3)[1] for r in (ours, theirs))
        for name in ("X-TDAPI-KV-Sketch", "X-TDAPI-KV-Occ"):
            assert got[name] == want[name], (name, row[:4])
        seen.append(got["X-TDAPI-KV-Sketch"])
    assert len(set(seen)) > 1 and int(got["X-TDAPI-KV-Occ"]) > 0
    hg, hw = _health(ours.port), _health(theirs.port)
    assert hg["prefixCache"] == hw["prefixCache"]
    assert hg["paged"] == hw["paged"]
    assert hg["prefixHits"] == hw["prefixHits"] >= 1
    assert list(hg) == list(hw)                  # the blocks, in order


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_export_equals_the_jax_servers(tiny, kv_quant):
    """The prefill phase of the same prompt on both servers, then GET /kv:
    the same envelope (tokens, length, buffer names, numpy dtypes, shapes);
    int8 buffers byte for byte, float32 ones (the f32 pool, the kv8
    scales) within TOL, since the two packages sum in other orders. A
    second GET of the key is the same 404 envelope on both."""
    pair = [_Replica(tiny, pkg, kv_quant=kv_quant) for pkg in ("port", "jax")]
    try:
        prompt = _prompts(4, (22,))[0]
        hdr = {"X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": "k1"}
        firsts = [_generate(r.port, prompt, 9, hdr)[0] for r in pair]
        assert firsts[0] == firsts[1] and len(firsts[0]) == 1
        got, want = (json.loads(_raw(r.port, "GET", "/kv?key=k1")[1])
                     for r in pair)
        again = [_raw(r.port, "GET", "/kv?key=k1")[1] for r in pair]
    finally:
        for r in pair:
            r.close()
    assert got["code"] == want["code"] == 200
    gd, wd = got["data"], want["data"]
    assert (gd["tokens"], gd["len"]) == (wd["tokens"], wd["len"]) == (
        prompt, 22)
    names = ["k", "v", "ks", "vs"] if kv_quant else ["k", "v"]
    assert list(gd["bufs"]) == list(wd["bufs"]) == names
    for name, g in gd["bufs"].items():
        w = wd["bufs"][name]
        assert (g["dtype"], g["shape"]) == (w["dtype"], w["shape"])
        assert g["shape"][1] == 6                       # ceil(22 / 4) blocks
        if g["dtype"] == "int8":
            assert g["b64"] == w["b64"], name
        else:
            assert g["dtype"] == "float32"
            np.testing.assert_allclose(
                np.frombuffer(base64.b64decode(g["b64"]), np.float32),
                np.frombuffer(base64.b64decode(w["b64"]), np.float32), **TOL)
    assert again[0] == again[1]
    assert json.loads(again[0]) == {"code": 404, "msg": "kv export not found",
                                    "data": None}


# ---- the handoff across the packages -------------------------------------------

@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_handoff_across_the_packages(tiny, direction):
    """The prefill phase on one package's replica, the decode phase on the
    other's: the decode replica imports the export (handoffsIn 1), its
    output continues the prompt's greedy stream as a plain full request
    does, and a second fetch of the key is a 404."""
    pre_pkg, dec_pkg = direction.split(" to ")
    pre = _Replica(tiny, pre_pkg)
    dec = _Replica(tiny, dec_pkg, prefix_cache=4)
    try:
        prompt = _prompts(5, (21,))[0]
        first, _ = _generate(pre.port, prompt, 10, {
            "X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": "hand"})
        row = prompt + first
        got, hdrs = _generate(dec.port, row, 9, {
            "X-TDAPI-KV-Key": "hand",
            "X-TDAPI-KV-Source": f"127.0.0.1:{pre.port}"})
        assert "X-TDAPI-KV-Sketch" in hdrs
        assert first + got == _solo(tiny, prompt, 10)
        assert _health(dec.port)["prefixCache"]["handoffsIn"] == 1
        again = json.loads(_raw(pre.port, "GET", "/kv?key=hand")[1])
        assert again["code"] == 404
        full, _ = _generate(dec.port, row, 9)           # a plain request
        assert full == got
        assert _health(dec.port)["prefixCache"]["handoffsIn"] == 1
        for rep in (pre, dec):
            cache = rep.srv.batcher.cache
            if "host_pages" in cache:        # the port's: mirrors agree
                assert cache["pages"].tolist() == cache["host_pages"]
                assert cache["lengths"].tolist() == cache["host_lengths"]
        deadline = time.time() + 10                     # the take is purged
        while _health(pre.port)["paged"]["freeBlocks"] != (
                pre.srv.batcher.kv_pool_blocks - 1):
            assert time.time() < deadline
            time.sleep(0.01)
    finally:
        pre.close()
        dec.close()


class _BadKV(BaseHTTPRequestHandler):
    """A prefill peer whose /kv answers with an export of the wrong
    geometry (or, for key "junk", with bytes that are not JSON)."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        if "junk" in self.path:
            payload = b"not json"
        else:
            arr = np.zeros((2, 1, 3), np.float32)
            buf = {"dtype": "float32", "shape": list(arr.shape),
                   "b64": base64.b64encode(arr.tobytes()).decode()}
            payload = json.dumps({"code": 200, "msg": "Success", "data": {
                "tokens": self.server.tokens, "len": len(self.server.tokens),
                "bufs": {"k": buf, "v": buf}}}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@pytest.mark.parametrize("fault", ["expired", "wrong geometry", "not json",
                                   "peer gone"])
def test_a_failed_fetch_falls_back_to_a_full_prefill(tiny, monkeypatch,
                                                     fault):
    """The decode phase whose export is gone (expired on its replica),
    malformed, or unreachable serves the request by prefilling it in full:
    the greedy stream is exact and nothing is imported."""
    prompt = _prompts(6, (13,))[0]
    want = _solo(tiny, prompt, 6)
    row = prompt + want[:1]
    peers = []
    if fault == "expired":
        monkeypatch.setenv("TDAPI_KV_EXPORT_TTL_S", "0")
        pre = _Replica(tiny, "port")
        monkeypatch.delenv("TDAPI_KV_EXPORT_TTL_S")
        peers.append(pre)
        first, _ = _generate(pre.port, prompt, 6, {
            "X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": "gone"})
        assert first == want[:1]
        deadline = time.time() + 10          # purged at the next tick
        while pre.srv.batcher._kv_exports:
            assert time.time() < deadline
            time.sleep(0.01)
        source, key = f"127.0.0.1:{pre.port}", "gone"
    elif fault == "peer gone":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            source, key = f"127.0.0.1:{s.getsockname()[1]}", "any"
    else:
        bad = ThreadingHTTPServer(("127.0.0.1", 0), _BadKV)
        bad.tokens = prompt
        threading.Thread(target=bad.serve_forever, daemon=True).start()
        source = f"127.0.0.1:{bad.server_address[1]}"
        key = "junk" if fault == "not json" else "geom"
    dec = _Replica(tiny, "port", prefix_cache=4)
    try:
        got, _ = _generate(dec.port, row, 5, {"X-TDAPI-KV-Key": key,
                                              "X-TDAPI-KV-Source": source})
        assert want[:1] + got == want
        assert dec.srv.batcher.kv_handoffs_in == 0
        assert _health(dec.port)["prefixCache"]["handoffsIn"] == 0
    finally:
        dec.close()
        for p in peers:
            p.close()
        if fault in ("wrong geometry", "not json"):
            bad.shutdown()
            bad.server_close()


def test_handoff_headers_are_ignored_without_a_paged_batcher(tiny):
    """A dense batcher serves a prefill-phase request as a plain one (its
    max_new stands) and sends no sketch; /kv is the 404 envelope."""
    jcfg, tcfg, jp_, tp_ = tiny
    srv = tserve._Server(tcfg, tp_)
    srv.batcher = tserve._Batcher(tcfg, tp_, slots=1, max_len=32)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserve._handler_for(srv, "llama/tiny"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        got, hdrs = _generate(port, [5, 9, 2, 7], 4, {
            "X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": "k"})
        assert len(got) == 4 and "X-TDAPI-KV-Sketch" not in hdrs
        assert json.loads(_raw(port, "GET", "/kv?key=k")[1])["code"] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.batcher.close()


# ---- the serve command ---------------------------------------------------------------

def test_paged_serve_command_serves_generate_kv_and_the_sketch(tmp_path):
    """`serve --device cpu --config tiny --batch-slots 4 --kv-block 16
    --prefix-cache 4` in a subprocess: it prints its paged mode, /generate
    carries the sketch headers, a prefill-phase request's export is served
    once by GET /kv, and healthz has the paged and prefixCache blocks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "serve.log", "w+", encoding="utf-8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_docker_api_tpu_torch.workloads.serve",
         "--device", "cpu", "--config", "tiny", "--batch-slots", "4",
         "--kv-block", "16", "--prefix-cache", "4", "--host", "127.0.0.1",
         "--port", str(port)], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None and time.time() < deadline, (
                log.seek(0) or log.read())
            try:
                health = _health(port)
                break
            except OSError:
                time.sleep(0.2)
        assert health["paged"] == {"blockSize": 16, "poolBlocks": 1 + 4 * 8,
                                   "freeBlocks": 4 * 8}
        prompt = _prompts(7, (40,))[0]
        got, hdrs = _generate(port, prompt, 5)
        assert len(got) == 5 and len(hdrs["X-TDAPI-KV-Sketch"]) == 64
        assert hdrs["X-TDAPI-KV-Occ"] == "2"
        first, _ = _generate(port, prompt + [1], 5, {
            "X-TDAPI-Phase": "prefill", "X-TDAPI-KV-Key": "cli"})
        assert len(first) == 1
        export = json.loads(_raw(port, "GET", "/kv?key=cli")[1])
        assert export["code"] == 200 and export["data"]["len"] == 41
        assert json.loads(_raw(port, "GET", "/kv?key=cli")[1])["code"] == 404
        assert _health(port)["prefixCache"]["entries"] == 1
        log.seek(0)
        assert ("continuous batching: 4 slots x 128 tokens, paged (33 x 16 "
                "token blocks) KV") in log.read()
    finally:
        proc.kill()
        proc.wait(timeout=60)
        log.close()
