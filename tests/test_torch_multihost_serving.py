"""PyTorch port, multi-host serving on the CPU: two workers, each a process
formed from its own contract env (TPU_WORKER_HOSTNAMES, TPU_WORKER_ID,
JAX_COORDINATOR_ADDRESS) on 127.0.0.1, one gloo rank each, tp=2 (JAX's
serving plan), `tiny` in f32 on weights converted from the JAX init.

- single-flight: greedy tokens equal to JAX's generate on the same
  weights; the logits of the generated sequence under teacher forcing
  within test_torch_infer.py's f32 tolerance of JAX's llama_forward; a
  sampled request gives the same tokens on both ranks;
- the lock-step batcher: 6 staggered requests into 4 slots, each greedy
  stream equal to the JAX single-host _Batcher's, dense, paged (16-token
  blocks) with the prefix cache, int8 KV, a draft, and --shard-kv (each
  rank's K/V and scale bytes exactly 1/tp of the whole cache's, lengths
  and page tables whole); MoE tiny under one hand-driven schedule against
  the JAX _Batcher under the same one;
- the rounding invariant: temperature 1e-46 (non-zero in f64, zero in f32)
  takes the greedy program on both ranks (no generator draw);
- serve.main over HTTP on two workers (single-flight and batched) against
  the port's one-rank generate, and rank 0's stop ending both with 0;
- crash liveness: a planted rank-0 failure ends the follower, a killed
  idle single-flight rank 0 ends its follower, a planted
  follower failure ends rank 0 non-zero, each within a timeout;
- JAX's multi-host refusals, with its messages.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import infer as jinfer
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.workloads import serve as jserve
from gpu_docker_api_tpu_torch import batching as tbatching
from gpu_docker_api_tpu_torch import distributed
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch import paging as tpaging
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.train import (
    Trainer, tree_leaves, tree_map_named,
)
from gpu_docker_api_tpu_torch.workloads import serve as tserve

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402  (scheduled_streams)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
MAX_NEW = 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)      # tests/test_torch_infer.py's TOL
BATCH = dict(slots=4, max_len=64)
BATCH_CASES = {                 # name: lock-step knobs (+ draft, moe)
    "dense": dict(kw=BATCH),
    "paged, prefix cache": dict(kw=dict(BATCH, kv_block=16, prefix_cache=4)),
    "int8 KV": dict(kw=dict(BATCH, kv_quant=True)),
    "draft": dict(kw=dict(BATCH, gamma=3), draft=True),
    "shard_kv": dict(kw=dict(BATCH, shard_kv=True)),
    "shard_kv, paged, int8 KV": dict(kw=dict(BATCH, shard_kv=True,
                                             kv_block=16, kv_quant=True)),
    "temperature 1e-46": dict(kw=BATCH, temperature=1e-46),
    "moe": dict(kw=dict(slots=3, max_len=48), moe=True),
}
# the JAX _Batcher each case is held to (a JAX composition of the same
# knobs; --shard-kv has none on one host: its streams are the dense ones)
JAX_OF = {"dense": "dense", "paged, prefix cache": "paged, prefix cache",
          "int8 KV": "int8 KV", "draft": "draft", "shard_kv": "dense",
          "shard_kv, paged, int8 KV": "int8 KV",
          "temperature 1e-46": "dense"}
MOE_AT = (0, 1, 3, 6, 8)
DEADLINE_S = 150


def _prompts():
    """6 prompts, 4 of them sharing a 20-token prefix (the prefix cache's
    and in-flight sharing's)."""
    rng = np.random.default_rng(61)
    base = rng.integers(0, 256, 20)
    shared = [np.concatenate([base, rng.integers(0, 256, n)])
              for n in (3, 5, 8, 11)]
    return [p.astype(np.int32) for p in shared + [
        rng.integers(0, 256, n) for n in (6, 9)]]


def _trees():
    jcfg, mcfg = jllama.LlamaConfig.tiny(), jmoe.MoEConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                       jax.random.key(0)))
    draft = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                        jax.random.key(42)))
    moe = jax.tree.map(np.asarray, jmoe.init_params(mcfg, jax.random.key(3)))
    return jcfg, mcfg, tree, draft, moe


def _jax_batcher(jcfg, jp, prompts, **kw):
    b = jserve._Batcher(jcfg, jp, **kw)
    ex = ThreadPoolExecutor(len(prompts))
    try:
        futs = [ex.submit(b.submit, jnp.asarray(p), MAX_NEW)
                for p in prompts]
        return [f.result(timeout=180) for f in futs]
    finally:
        b.close()
        ex.shutdown(wait=True)


def _jax_refs(jcfg, mcfg, tree, draft, moe, prompt, prompts, moe_prompts):
    """JAX's single-flight tokens and teacher-forced logits, each
    composition's _Batcher streams, and MoE's under the schedule."""
    jp = jax.tree.map(jnp.asarray, tree)
    greedy = np.asarray(jinfer.generate(jp, jnp.asarray(prompt)[None], jcfg,
                                        MAX_NEW)).tolist()
    seq = jnp.concatenate([jnp.asarray(prompt)[None],
                           jnp.asarray(greedy, jnp.int32)], axis=1)
    logits = np.asarray(jllama.llama_forward(jp, seq, jcfg, impl="xla"))
    batchers = {}
    for name, case in BATCH_CASES.items():
        if case.get("moe") or JAX_OF[name] != name:
            continue
        kw = dict(case["kw"])
        if case.get("draft"):
            kw["draft"] = (jcfg, jax.tree.map(jnp.asarray, draft))
        batchers[name] = _jax_batcher(jcfg, jp, prompts, **kw)
    mb = jserve._Batcher(mcfg, jax.tree.map(jnp.asarray, moe),
                         **BATCH_CASES["moe"]["kw"])
    fns = (mb._fn_decode(), mb._fn_decode_pick(), mb._fn_decode_multi())
    try:
        moe_streams = cs.scheduled_streams(
            mb, lambda: mb._tick(*fns), [jnp.asarray(p) for p in moe_prompts],
            MOE_AT, MAX_NEW)
    finally:
        mb.close()
    return {"greedy": greedy, "logits": logits, "batchers": batchers,
            "moe": moe_streams}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The two workers' results (serve_cases), and JAX's references,
    computed while the workers run."""
    jcfg, mcfg, tree, draft, moe = _trees()
    prompt = np.random.default_rng(60).integers(0, 256, 11).astype(np.int32)
    prompts = _prompts()
    moe_prompts = [np.random.default_rng(40).integers(0, 256, n)
                   .astype(np.int32) for n in (5, 9, 6, 12, 7)]
    tmp = str(tmp_path_factory.mktemp("multihost"))
    payload = dict(tp=TP, config=tllama.LlamaConfig.tiny(), params=tree,
                   draft_params=draft, moe_config=tmoe.MoEConfig.tiny(),
                   moe_params=moe, prompt=prompt, max_new=MAX_NEW, seed=5,
                   prompts=prompts, stagger=0.05, moe_prompts=moe_prompts,
                   moe_at=MOE_AT, batch_cases=BATCH_CASES)
    got = {}
    t = threading.Thread(target=lambda: got.update(ranks=workers.run_workers(
        workers.serve_cases, payload, 2, 2, tmp, timeout=DEADLINE_S)))
    t.start()
    try:
        refs = _jax_refs(jcfg, mcfg, tree, draft, moe, prompt, prompts,
                         moe_prompts)
    finally:
        t.join()
    assert "ranks" in got, "the workers failed"
    return got["ranks"], refs, prompts


def test_ranks_hold_one_tp_th_of_each_matrix(served):
    """Each rank's leaves are its cut of the plan (fsdp 1 x tp 2): every
    matrix (embed, lm_head, the layers' projections) exactly 1/tp, the
    norms whole."""
    ranks, _, _ = served
    plan = ranks[0]["plan"]
    assert (plan.tp, plan.fsdp) == (TP, 1)
    cfg = tllama.LlamaConfig.tiny()
    want = tree_map_named(
        lambda path, sd: (sd[0], 1 if path.endswith("norm") else TP),
        tllama.param_shapes(cfg))
    for r in ranks:
        got = tree_map_named(lambda path, shape: (path, shape),
                             r["leaf_shapes"])
        for (path, shape), (full, cut) in zip(tree_leaves(got),
                                              tree_leaves(want)):
            assert np.prod(shape) * cut == np.prod(full), path


def test_single_flight_greedy_equals_jax_generate(served):
    ranks, refs, _ = served
    for r in ranks:
        assert r["greedy"] == refs["greedy"]


def test_single_flight_teacher_forced_logits_within_f32_tol(served):
    ranks, refs, _ = served
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), refs["logits"],
                                   **F32_TOL)


def test_sampled_request_draws_the_same_tokens_on_every_rank(served):
    ranks, _, _ = served
    assert ranks[0]["sampled"] == ranks[1]["sampled"]
    assert len(ranks[0]["sampled"][0]) == MAX_NEW


@pytest.mark.parametrize("case", [c for c in BATCH_CASES if c != "moe"])
def test_lockstep_streams_equal_the_jax_batchers(served, case):
    """6 staggered requests into 4 slots: rank 0's streams, in order, equal
    the JAX _Batcher's; every rank finished the same streams."""
    ranks, refs, prompts = served
    got = [r[case] for r in ranks]
    assert got[0]["out"] == refs["batchers"][JAX_OF[case]]
    assert got[1]["recorded"] == got[0]["recorded"]
    assert len(got[0]["recorded"]) == len(prompts)


@pytest.mark.parametrize("case", ["shard_kv", "shard_kv, paged, int8 KV"])
def test_shard_kv_holds_one_tp_th_of_the_kv_bytes(served, case):
    """--shard-kv: each rank's K/V (and kv8 scales) exactly 1/tp of the
    whole cache's bytes, cut on the kv-head dim (kv_shard_specs), the
    lengths and page tables whole."""
    ranks, _, _ = served
    cfg = tllama.LlamaConfig.tiny()
    kw = BATCH_CASES[case]["kw"]
    if kw.get("kv_block"):
        pages = -(-kw["max_len"] // kw["kv_block"])
        whole = tpaging.init_paged_cache(
            cfg, 1 + kw["slots"] * pages, kw["kv_block"], kw["slots"], pages,
            quantized=kw.get("kv_quant", False), device="cpu")
    else:
        whole = tbatching.init_slot_cache(cfg, kw["slots"], kw["max_len"],
                                          device="cpu")
    bufs = [k for k in ("k", "v", "ks", "vs") if k in whole]
    for r in ranks:
        shapes = r[case]["cache_shapes"]
        for k in bufs:
            want = list(whole[k].shape)
            want[-2] //= TP
            assert list(shapes[k]) == want, k
        held = sum(np.prod(shapes[k]) * whole[k].element_size()
                   for k in bufs)
        assert held * TP == sum(whole[k].numel() * whole[k].element_size()
                                for k in bufs)
        for k in ("lengths", "pages"):
            if k in whole:
                assert shapes[k] == tuple(whole[k].shape)


def test_temperature_that_rounds_to_f32_zero_is_greedy_on_every_rank(served):
    ranks, refs, _ = served
    for r in ranks:
        assert not r["temperature 1e-46"]["drew"]
    assert ranks[0]["temperature 1e-46"]["out"] == refs["batchers"]["dense"]
    assert (ranks[1]["temperature 1e-46"]["recorded"]
            == ranks[0]["temperature 1e-46"]["recorded"])


def test_moe_lockstep_streams_equal_the_jax_batcher_under_one_schedule(
        served):
    ranks, refs, _ = served
    assert ranks[0]["moe"]["out"] == refs["moe"]
    assert ranks[1]["moe"]["recorded"] == ranks[0]["moe"]["recorded"]


# ---- serve.main over HTTP, two workers ------------------------------------

def _spawn_serve(argv, workers_n=2, fail_rank=-1, env_extra=None,
                 rounds_dir=None, **worker_kw):
    """workers_n serve.main worker processes from their contract envs
    (worker_kw: workers.serve_main_worker's; with rounds_dir, worker w
    counts its broadcasts in rounds_dir/rounds<w>)."""
    import multiprocessing as mp
    coordinator = f"127.0.0.1:{distributed.free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for w in range(workers_n):
        env = dict(workers.cluster_env(w, workers_n, coordinator),
                   **(env_extra or {}))
        if rounds_dir is not None:
            worker_kw["rounds_path"] = os.path.join(rounds_dir, f"rounds{w}")
        procs.append(ctx.Process(target=workers.serve_main_worker,
                                 args=(env, argv, fail_rank),
                                 kwargs=dict(worker_kw)))
        procs[-1].start()
    return procs


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, json.dumps(body) if body else None)
        resp = conn.getresponse()
        return json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def _wait_healthz(port, procs, deadline=90):
    t0 = time.monotonic()
    while True:
        try:
            return _call(port, "GET", "/healthz")[0]
        except OSError:
            assert all(p.is_alive() for p in procs), "a worker died"
            assert time.monotonic() - t0 < deadline, "no /healthz"
            time.sleep(0.2)


@pytest.mark.parametrize("extra", [[], ["--batch-slots", "4",
                                        "--kv-block", "16", "--shard-kv"]])
def test_serve_main_on_two_workers_answers_and_stops(extra):
    """serve.main on two workers (tp=2): /healthz reports the whole
    model, a greedy request equals the port's one-rank generate on the
    same init, and SIGINT to rank 0 stops both workers with 0."""
    port = distributed.free_port()
    procs = _spawn_serve(["--device", "cpu", "--config", "tiny", "--port",
                          str(port), "--host", "127.0.0.1"] + extra)
    try:
        health = _wait_healthz(port, procs)
        cfg = tllama.LlamaConfig.tiny()
        assert health["data"]["params"] == tserve._whole_params(cfg)
        assert ("batching" in health["data"]) == bool(extra)
        tokens = [[5, 9, 2, 7, 31]]
        got, hdrs = _call(port, "POST", "/generate",
                          {"tokens": tokens, "max_new": MAX_NEW})
        one = Trainer.create(cfg, device="cpu").init_params(0)
        want = ti.generate(one, torch.tensor(tokens), cfg, MAX_NEW).tolist()
        assert got["data"]["tokens"] == want
        assert ("X-TDAPI-Slots" in hdrs) == bool(extra)
        os.kill(procs[0].pid, signal.SIGINT)
        codes = workers.wait_workers(procs, 60)
        assert codes == [0, 0]
    finally:
        workers.wait_workers([p for p in procs if p.is_alive()], 1)


@pytest.mark.parametrize("fail_rank, want", [(0, [1, 0]), (1, [1, 1])])
def test_a_planted_crash_ends_every_worker(fail_rank, want):
    """The lock-step scheduler of rank `fail_rank` raises at its third
    tick: rank 0's crash broadcasts the stop op (the follower exits 0, rank
    0 non-zero); a follower's crash ends it non-zero and fails rank 0's
    next broadcast (rank 0 non-zero). Neither hangs."""
    procs = _spawn_serve(["--device", "cpu", "--config", "tiny", "--port",
                          str(distributed.free_port()), "--host",
                          "127.0.0.1", "--batch-slots", "2"],
                         fail_rank=fail_rank)
    assert workers.wait_workers(procs, 90) == want


def test_a_killed_rank_0_ends_an_idle_single_flight_follower(tmp_path):
    """Single-flight rank 0 with no request broadcasts an idle no-op round
    every SERVE_IDLE_S (0.05 s here), so an idle follower never waits in a
    broadcast near the group's timeout. SIGKILL of rank 0, which sends no
    stop op, then ends the idle follower non-zero, without a hang."""
    port = distributed.free_port()
    procs = _spawn_serve(["--device", "cpu", "--config", "tiny", "--port",
                          str(port), "--host", "127.0.0.1"],
                         idle_s=0.05, rounds_dir=str(tmp_path))
    try:
        _wait_healthz(port, procs)
        time.sleep(1.0)
        with open(tmp_path / "rounds1") as f:
            idle_rounds = len(f.readlines())
        assert idle_rounds >= 5, idle_rounds
        assert procs[1].is_alive()
        os.kill(procs[0].pid, signal.SIGKILL)
        codes = workers.wait_workers(procs, 60)
        assert codes[0] == -signal.SIGKILL
        assert codes[1] not in (0, None), codes
    finally:
        workers.wait_workers([p for p in procs if p.is_alive()], 1)


# ---- JAX's multi-host refusals -------------------------------------------

@pytest.mark.parametrize("extra, message", [
    (["--quantize", "w8"], "--quantize is single-host serving for now; the "
     "multi-host engine runs plain sharded generate (drop the flag, or "
     "serve per-host)"),
    (["--host-load", "--quantize", "w8"], "--quantize is single-host "
     "serving for now"),
    (["--draft-config", "tiny"], "--draft-config in multihost mode runs "
     "inside the lock-step batcher (per-slot proposals, shared sharded "
     "verify) — add --batch-slots N"),
    (["--shard-kv"], "--shard-kv shards the batching scheduler's cache; it "
     "needs --batch-slots N"),
    (["--kv-block", "16"], "--prefix-cache/--kv-block/--kv-pool configure "
     "the batching scheduler; they need --batch-slots N (multihost or "
     "not)"),
    (["--prefix-cache", "4"], "--prefix-cache/--kv-block/--kv-pool "
     "configure the batching scheduler; they need --batch-slots N"),
    (["--batch-slots", "2", "--shard-kv", "--tp", "4"], None),
])
def test_multihost_refusals_are_the_jax_servers(monkeypatch, extra,
                                                message):
    """Each refusal is the JAX server's message (serve.py's multi-host
    arm: the same flags in the same order), raised before any group
    forms; --shard-kv under a tp that does not divide the kv heads (tiny's
    2 over tp 4) gets JAX's head-count message."""
    for k, v in workers.cluster_env(0, 2, "127.0.0.1:1").items():
        monkeypatch.setenv(k, v)
    if message is None:
        message = "--shard-kv needs n_kv_heads (2) divisible by tp (4)"
        monkeypatch.setattr(distributed, "run_cluster", lambda *a, **k: (
            pytest.fail("the group formed")))
    with pytest.raises(SystemExit) as e:
        tserve.main(["--device", "cpu", "--config", "tiny", "--port", "1"]
                    + extra)
    assert str(e.value).startswith(message)


def test_multihost_without_a_card_raises():
    """Without --device cpu a multi-worker grant needs the worker's cards:
    on a machine with none the server raises, and serves nothing on one
    host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, **workers.cluster_env(0, 2, "127.0.0.1:1"))
    out = subprocess.run([sys.executable, "-m",
                          "gpu_docker_api_tpu_torch.workloads.serve",
                          "--config", "tiny", "--port", "1"],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "serving" not in out.stdout
