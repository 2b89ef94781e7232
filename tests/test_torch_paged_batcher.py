"""PyTorch port, the paged branches of the continuous batcher
(workloads/serve.py _Batcher with kv_block > 0): the batcher tests of
tests/test_paging.py run on the port, and the port's greedy streams against
the JAX paged _Batcher's, on the same tiny weights (converted from the JAX
init) and numpy-seeded prompts, on the CPU. Every run ends with the pool
holding only what the prefix trie holds: no block leaks."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

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
from gpu_docker_api_tpu_torch import paging as tp
from gpu_docker_api_tpu_torch.models import llama as tllama
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
    _, tcfg, _, tp_ = tiny
    return tserve._Batcher(tcfg, tp_, **kw)


def _concurrent(b, prompts, max_new, close=True, **submit_kw):
    ex = ThreadPoolExecutor(len(prompts))
    try:
        futs = [ex.submit(b.submit, p, max_new, **submit_kw) for p in prompts]
        return [f.result(timeout=180) for f in futs]
    finally:
        if close:
            b.close()
        ex.shutdown(wait=True)


def _no_leak(b):
    """Nothing in flight: the pool holds the trie's blocks only, and the
    device page table is its host mirror."""
    held = len(b._trie) if b._trie is not None else 0
    assert b._alloc.free_blocks == b.kv_pool_blocks - 1 - held
    assert b.cache["pages"].tolist() == b.cache["host_pages"]
    assert b.cache["lengths"].tolist() == b.cache["host_lengths"]


# ---- the port's streams against the JAX paged _Batcher's -------------------------

STREAM_CASES = {
    # 4-token blocks: ceil((prompt + 7) / 4) = 4..6 blocks a request, 2
    # slots, 9 usable blocks: admissions wait on blocks
    "pool smaller than full capacity": dict(slots=2, kv_pool_blocks=10),
    "speculative rounds with a draft": dict(slots=2, gamma=3, draft=True),
    "prefix shared by in-flight requests": dict(slots=3, prefill_chunk=4,
                                                prefix_cache=2),
    "kv_quant": dict(slots=2, kv_quant=True, decode_chunk=3),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_greedy_streams_equal_the_jax_paged_batchers(tiny, case):
    """Five requests (two sharing a 12-token prefix) into a paged batcher
    with 4-token blocks: each stream equals the JAX paged _Batcher's, and
    the drained pool leaks no block."""
    jcfg, tcfg, jp_, tp_ = tiny
    kw = dict(STREAM_CASES[case], max_len=64, kv_block=4)
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
    jb = jserve._Batcher(jcfg, jp_, **jkw)
    want = _concurrent(jb, [jnp.asarray(p) for p in prompts], 7)
    ours = tserve._Batcher(tcfg, tp_, **tkw)
    got = _concurrent(ours, [_long(p) for p in prompts], 7, close=False)
    ours.close()
    assert got == want
    assert got == [_solo(tp_, tcfg, p, 7, kv_quant=kw.get("kv_quant", False))
                   for p in prompts]
    _no_leak(ours)


# ---- tests/test_paging.py's batcher tests, on the port ------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_paged_batcher_stream_matches_generate(tiny, quantized):
    """One request through the paged batcher (plain and int8 pool) is
    infer.generate's greedy stream."""
    _, tcfg, _, tp_ = tiny
    b = _batcher(tiny, slots=2, max_len=32, kv_block=4, kv_quant=quantized)
    try:
        got = b.submit(_long([5, 9, 2, 7, 11, 3]), 8)
    finally:
        b.close()
    assert got == _solo(tp_, tcfg, [5, 9, 2, 7, 11, 3], 8, kv_quant=quantized)


def test_pool_memory_is_independent_of_slots_times_max_len(tiny):
    """16 slots x 128 tokens over a 9-block pool of 8 tokens hold 72 tokens
    of KV, 17x less than the dense 16 x 128, and still serve correctly."""
    _, tcfg, _, tp_ = tiny
    b = _batcher(tiny, slots=16, max_len=128, kv_block=8, kv_pool_blocks=9)
    try:
        assert b.cache["k"].shape[1] * b.cache["k"].shape[2] == 9 * 8
        assert 9 * 8 * 17 <= 16 * 128
        assert b.submit(_long([5, 9, 2, 7]), 6) == _solo(tp_, tcfg,
                                                         [5, 9, 2, 7], 6)
    finally:
        b.close()


def test_paged_batcher_streams_match_dense(tiny):
    _, tcfg, _, tp_ = tiny
    prompts = _prompts(1, (4, 7, 10))
    b = _batcher(tiny, slots=3, max_len=64, kv_block=8)
    got = _concurrent(b, [_long(p) for p in prompts], 5)
    assert got == [_solo(tp_, tcfg, p, 5) for p in prompts]


def test_admission_waits_for_free_blocks(tiny):
    """A pool that holds one request (4 + 12 tokens = 2 blocks) serves two
    concurrent ones in turn, and every block comes back."""
    _, tcfg, _, tp_ = tiny
    prompts = [[5, 9, 2, 7], [1, 3, 3, 8]]
    b = _batcher(tiny, slots=2, max_len=32, kv_block=8, kv_pool_blocks=3)
    got = _concurrent(b, [_long(p) for p in prompts], 12, close=False)
    b.close()
    assert got == [_solo(tp_, tcfg, p, 12) for p in prompts]
    assert b._alloc.free_blocks == 2


def test_oversized_request_rejected_up_front(tiny):
    """A request the pool could never hold is refused at submit with the
    JAX _Batcher's message."""
    jcfg, _, jp_, _ = tiny
    ours = _batcher(tiny, slots=1, max_len=64, kv_block=8, kv_pool_blocks=3)
    theirs = jserve._Batcher(jcfg, jp_, slots=1, max_len=64, kv_block=8,
                             kv_pool_blocks=3)
    try:
        with pytest.raises(ValueError, match="never be admitted") as got:
            ours.submit(torch.zeros(30, dtype=torch.long), 20)
        with pytest.raises(ValueError) as want:
            theirs.submit(jnp.zeros((30,), jnp.int32), 20)
        assert str(got.value) == str(want.value)
    finally:
        ours.close()
        theirs.close()


def test_paged_chunked_prefill_stream_exact(tiny):
    _, tcfg, _, tp_ = tiny
    prompt = _prompts(9, (11,))[0]
    b = _batcher(tiny, slots=2, max_len=64, kv_block=8, prefill_chunk=4)
    try:
        assert b.submit(_long(prompt), 6) == _solo(tp_, tcfg, prompt, 6)
    finally:
        b.close()


def test_paged_prefix_sharing_zero_copy(tiny):
    """A second request extending a stored prompt points its page table at
    the shared blocks (no new blocks for the prefix, no copy) and still
    streams exactly."""
    _, tcfg, _, tp_ = tiny
    sys_prompt = [5, 9, 2, 7, 11, 3, 1, 4]            # 2 full blocks
    p1, p2 = sys_prompt + [8, 6], sys_prompt + [2, 13, 10]
    b = _batcher(tiny, slots=2, max_len=64, kv_block=4, kv_pool_blocks=24,
                 prefix_cache=4)
    try:
        assert b.submit(_long(p1), 6) == _solo(tp_, tcfg, p1, 6)
        free_after_1 = b._alloc.free_blocks
        assert b.prefix_hits == 0
        assert b.submit(_long(p2), 6) == _solo(tp_, tcfg, p2, 6)
        assert b.prefix_hits == 1
        # every private block came back; p2's full blocks are p1's, already
        # in the trie
        assert b._alloc.free_blocks == free_after_1
        assert len(b._trie) == 2
    finally:
        b.close()
    _no_leak(b)


def test_paged_prefix_eviction_returns_blocks(tiny):
    """Every completed prompt stays in the trie until pool pressure, which
    evicts LRU leaves until the request fits: the pool never leaks."""
    _, tcfg, _, tp_ = tiny
    b = _batcher(tiny, slots=1, max_len=32, kv_block=4, kv_pool_blocks=12,
                 prefix_cache=1)
    try:
        total = b._alloc.free_blocks
        for p in _prompts(40, (8, 8, 8)):
            b.submit(_long(p), 4)
        assert b._alloc.free_blocks == total - 6
        assert len(b._trie) == 6
        # ceil((8 + 24) / 4) = 8 blocks > 5 free: leaves go
        p = _prompts(41, (8,))[0]
        assert b.submit(_long(p), 24) == _solo(tp_, tcfg, p, 24)
        assert b.prefix_evictions >= 3
    finally:
        b.close()
    _no_leak(b)


def test_paged_prefix_composes_with_kv_quant(tiny):
    _, tcfg, _, tp_ = tiny
    sys_prompt = [5, 9, 2, 7, 11, 3, 1, 4]
    b = _batcher(tiny, slots=1, max_len=64, kv_block=4, prefix_cache=2,
                 kv_quant=True)
    try:
        b.submit(_long(sys_prompt + [8]), 4)
        got = b.submit(_long(sys_prompt + [2, 13]), 6)
        assert b.prefix_hits == 1
    finally:
        b.close()
    assert got == _solo(tp_, tcfg, sys_prompt + [2, 13], 6, kv_quant=True)


def test_decode_chunk_streams_match_generate(tiny):
    """decode_chunk 5 over the paged cache: budgets end mid-chunk, a late
    request joins mid-stream, both streams exact."""
    _, tcfg, _, tp_ = tiny
    prompts, new = [[5, 9, 2, 7], [1, 3, 3, 8, 2]], [12, 7]
    b = _batcher(tiny, slots=2, max_len=64, kv_block=8, decode_chunk=5)
    got = [None, None]

    def ask(i):
        got[i] = b.submit(_long(prompts[i]), new[i])

    try:
        ts = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        ts[0].start()
        time.sleep(0.05)
        ts[1].start()
        for t in ts:
            t.join(timeout=120)
    finally:
        b.close()
    assert got == [_solo(tp_, tcfg, p, n) for p, n in zip(prompts, new)]


def test_batcher_stress_mixed_traffic(tiny):
    """12 concurrent requests (greedy and sampled, varied lengths) through a
    small pool with chunked prefill, the prefix trie and decode chunks:
    every greedy stream exact, every sampled one well-formed, no leak."""
    import random
    _, tcfg, _, tp_ = tiny
    b = _batcher(tiny, slots=3, max_len=64, kv_block=8, kv_pool_blocks=12,
                 prefill_chunk=4, prefix_cache=2, decode_chunk=4, seed=3)
    rng = random.Random(0)
    sys_prompt = [5, 9, 2, 7, 11, 3, 1, 4]
    jobs = []
    for i in range(12):
        body = [rng.randrange(256) for _ in range(rng.randrange(1, 6))]
        jobs.append((sys_prompt + body, rng.randrange(3, 9),
                     0.0 if i % 3 else 0.9))
    ex = ThreadPoolExecutor(len(jobs))
    try:
        futs = [ex.submit(b.submit, _long(p), n, temperature=t, top_k=12)
                for p, n, t in jobs]
        got = [f.result(timeout=300) for f in futs]
    finally:
        b.close()
        ex.shutdown(wait=True)
    for (p, n, t), g in zip(jobs, got):
        assert len(g) == n and all(0 <= x < 256 for x in g)
        if t == 0.0:
            assert g == _solo(tp_, tcfg, p, n)
    _no_leak(b)


def test_pool_pressure_evicts_stored_prefixes(tiny):
    """A request that needs a stored prefix's blocks evicts it instead of
    waiting behind it forever."""
    _, tcfg, _, tp_ = tiny
    b = _batcher(tiny, slots=1, max_len=64, kv_block=4, kv_pool_blocks=8,
                 prefix_cache=4)
    try:
        b.submit(_long([5, 9, 2, 7, 11, 3, 1, 4]), 4)
        assert len(b._trie) == 2
        p = _prompts(42, (9,))[0]        # ceil((9 + 16) / 4) = 7 > 5 free
        assert b.submit(_long(p), 16) == _solo(tp_, tcfg, p, 16)
    finally:
        b.close()
    _no_leak(b)


def test_inbatch_identical_prompts_share_blocks(tiny):
    """4 identical prompts at once fit the pool only by sharing their
    prompt blocks (4 x 9 blocks > 32 usable; shared 9 + 3 x 7 = 30): all
    four run together, stream exactly, and the three followers count as
    hits, with the prefix store off."""
    _, tcfg, _, tp_ = tiny
    prompt = _long([5, 9, 2, 7, 11, 3, 1, 4, 6])
    want = _solo(tp_, tcfg, prompt, 24)
    b = _batcher(tiny, slots=4, max_len=36, kv_block=4, kv_pool_blocks=33)
    # admission waits until all four are queued, so they arrive as one
    # burst; the occupancy after each admission pass is recorded
    burst, peak = threading.Event(), [0]
    next_item, admit = b._next_item, b._admit
    b._next_item = lambda: next_item() if burst.is_set() else None

    def recorded():
        admit()
        peak[0] = max(peak[0], sum(s is not None for s in b.slots))

    b._admit = recorded
    ex = ThreadPoolExecutor(4)
    try:
        futs = [ex.submit(b.submit, prompt, 24) for _ in range(4)]
        while b.queue.qsize() < 4:
            time.sleep(0.001)
        burst.set()
        got = [f.result(timeout=120) for f in futs]
    finally:
        b.close()
        ex.shutdown(wait=True)
    assert peak[0] == 4                  # all four resident at once
    assert got == [want] * 4
    assert b.prefix_hits == 3
    assert b._alloc.free_blocks == 32


def test_inbatch_follower_waits_for_mid_prefill_donor(tiny):
    """A follower admitted while its donor is mid chunked prefill parks
    until the donor's write frontier passes the shared tokens, then
    streams exactly."""
    _, tcfg, _, tp_ = tiny
    prompt = _prompts(77, (32,))[0]
    b = _batcher(tiny, slots=2, max_len=64, kv_block=4, prefill_chunk=2)
    got = _concurrent(b, [_long(prompt)] * 2, 6)
    assert got == [_solo(tp_, tcfg, prompt, 6)] * 2
    assert b.prefix_hits == 1
    _no_leak(b)


def test_inbatch_common_prefix_different_tails(tiny):
    _, tcfg, _, tp_ = tiny
    sys_prompt = [5, 9, 2, 7, 11, 3, 1, 4]
    p1, p2 = sys_prompt + [8, 6, 12], sys_prompt + [2, 13]
    b = _batcher(tiny, slots=2, max_len=32, kv_block=4)
    got = _concurrent(b, [_long(p1), _long(p2)], 12)
    assert got == [_solo(tp_, tcfg, p1, 12), _solo(tp_, tcfg, p2, 12)]
    assert b.prefix_hits == 1
    assert b._alloc.free_blocks == b.kv_pool_blocks - 1


# ---- the port's own paths ------------------------------------------------------

def test_default_pool_is_full_capacity_with_the_spec_pad(tiny):
    """Pool = 1 + slots x ceil((max_len + gamma) / block), as the JAX
    batcher sizes it; the draft keeps a dense cache."""
    jcfg, tcfg, jp_, tp_ = tiny
    for kw in (dict(), dict(gamma=3, draft=True)):
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("draft"):
            jkw["draft"], tkw["draft"] = (jcfg, jp_), (tcfg, tp_)
        ours = tserve._Batcher(tcfg, tp_, slots=3, max_len=30, kv_block=4,
                               **tkw)
        theirs = jserve._Batcher(jcfg, jp_, slots=3, max_len=30, kv_block=4,
                                 **jkw)
        try:
            assert ours.kv_pool_blocks == theirs.kv_pool_blocks
            assert ours._max_pages == theirs._max_pages
            assert tuple(ours.cache["pages"].shape) == tuple(
                theirs.cache["pages"].shape)
            if kw:
                assert "pages" not in ours.d_cache
        finally:
            ours.close()
            theirs.close()


def test_host_mirrors_agree_after_admit_release_and_restart(tiny,
                                                            monkeypatch):
    """The page table and lengths on the device equal their host mirrors
    after admissions, releases, and a crash restart, which rebuilds the
    pool, the allocator and the trie together."""
    _, tcfg, _, tp_ = tiny
    real = tp.paged_prefill
    fails = {"n": 0}

    def flaky(*a, **k):
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("transient device error")
        return real(*a, **k)

    monkeypatch.setattr(tp, "paged_prefill", flaky)
    b = _batcher(tiny, slots=2, max_len=32, kv_block=4, prefix_cache=2)
    try:
        p = _prompts(43, (9, 13))
        _concurrent(b, [_long(x) for x in p], 5, close=False)
        _no_leak(b)
        assert len(b._trie) == 2 + 3
        fails["n"] = 1
        with pytest.raises(RuntimeError, match="batcher"):
            b.submit(_long(p[0]), 4)
        out, hits = None, b.prefix_hits
        for _ in range(50):
            try:
                out = b.submit(_long(p[1]), 5)
                break
            except RuntimeError:
                time.sleep(0.1)
        assert out == _solo(tp_, tcfg, p[1], 5)
        assert b.prefix_hits == hits       # the rebuilt trie started empty
        assert b._restarts_left == 2
    finally:
        b.close()
    _no_leak(b)


def test_paged_crash_releases_waiters_and_the_parked_item(tiny, monkeypatch):
    """A dying scheduler fails the slot's request and the item parked at
    the head of the line alike."""
    def boom(*a, **k):
        time.sleep(0.2)
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tp, "paged_prefill", boom)
    b = _batcher(tiny, slots=2, max_len=32, kv_block=4, kv_pool_blocks=6,
                 restarts=0)
    ex = ThreadPoolExecutor(2)
    try:
        futs = [ex.submit(b.submit, torch.zeros(4, dtype=torch.long), 12)
                for _ in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="batcher"):
                f.result(timeout=60)
    finally:
        b.close()
        ex.shutdown(wait=True)
    assert b._waiting is None and b.queued == 0
