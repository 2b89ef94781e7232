"""PyTorch port, batching.py: the slot cache, per-row prefill / decode /
verify, the rowwise filter and pick, the speculative acceptance and the
decode chunk, against the JAX package on the same tiny weights (converted
from the JAX init) and the same numpy-seeded tokens, on the CPU. Also the
JAX tests of tests/test_batching.py and the dense cases of
tests/test_spec_batch.py, run on the port."""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import batching as jb
from gpu_docker_api_tpu import infer as ji
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu_torch import batching as tb
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.workloads.serve import _Batcher

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params, port draft)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    dtree = jax.tree.map(np.asarray,
                         jllama.init_params(jcfg, jax.random.key(42)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg),
            convert.params_from_numpy(dtree, tcfg))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _long(a):
    return torch.from_numpy(np.array(a)).long()


def _cpu_cache(cfg, slots, max_len, quantized=False):
    return tb.init_slot_cache(cfg, slots, max_len, quantized=quantized,
                              device="cpu")


def _jax_solo(jp, jcfg, prompt, n, **kw):
    return np.asarray(ji.generate(jp, jnp.asarray(prompt)[None], jcfg,
                                  max_new=n, **kw))[0].tolist()


# ---- the slot cache and its per-row steps, against the JAX functions --------

@pytest.mark.parametrize("quantized", [False, True])
def test_init_slot_cache_matches_jax(quantized):
    got = _cpu_cache(tllama.LlamaConfig.tiny(), 3, 32, quantized)
    want = jb.init_slot_cache(jllama.LlamaConfig.tiny(), 3, 32,
                              quantized=quantized)
    assert set(got) == set(want) | {"host_lengths"}
    assert got["host_lengths"] == [0, 0, 0]
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_init_slot_cache_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.init_slot_cache(tllama.LlamaConfig.tiny(), 2, 8)


def _prefilled(tiny, quantized, lens=(7, 0, 12), seed=3):
    """JAX and port slot caches with rows prefilled to `lens` (0 = idle),
    row 2 in two pieces (plain, then append). Returns (jcache, tcache,
    [(jax logits, port logits)])."""
    jcfg, tcfg, jp, tp, _ = tiny
    jc = jb.init_slot_cache(jcfg, len(lens), 48, quantized=quantized)
    tc = _cpu_cache(tcfg, len(lens), 48, quantized)
    pairs = []
    for slot, p in enumerate(_prompts(seed, lens)):
        if not len(p):
            continue
        pieces = [p[:5], p[5:]] if len(p) > 8 else [p]
        for j, piece in enumerate(pieces):
            jl, jc = jb.slot_prefill(jp, jnp.asarray(piece)[None], jc,
                                     jnp.int32(slot), jcfg, append=j > 0)
            tl, tc = tb.slot_prefill(tp, _long(piece)[None], tc, slot, tcfg,
                                     append=j > 0)
            pairs.append((jl, tl))
    return jc, tc, pairs


@pytest.mark.parametrize("quantized", [False, True])
def test_slot_prefill_plain_and_append_match_jax(tiny, quantized):
    jc, tc, pairs = _prefilled(tiny, quantized)
    assert len(pairs) == 3                 # row 0 whole, row 2 in two pieces
    for jl, tl in pairs:
        assert tl.shape == (1, 256) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["host_lengths"] == [7, 0, 12]
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    if not quantized:
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_slot_decode_matches_jax(tiny, quantized):
    """Per-row frontiers 7 / 0 / 12, row 1 idle: the logits of every row
    (the idle row's junk too) and the lengths, step by step."""
    jcfg, tcfg, jp, tp, _ = tiny
    jc, tc, _ = _prefilled(tiny, quantized)
    active = [True, False, True]
    toks = np.array([5, 0, 9], np.int32)
    for _ in range(4):
        jl, jc = jb.slot_decode(jp, jnp.asarray(toks), jc,
                                jnp.asarray(active), jcfg)
        tl, tc = tb.slot_decode(tp, _long(toks), tc, active, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tc["host_lengths"] == [11, 0, 16]
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


@pytest.mark.parametrize("quantized", [False, True])
def test_slot_verify_matches_jax(tiny, quantized):
    """A [slots, T] block appended at each row's own frontier."""
    jcfg, tcfg, jp, tp, _ = tiny
    jc, tc, _ = _prefilled(tiny, quantized)
    active = [True, False, True]
    block = np.random.default_rng(4).integers(0, 256, (3, 5)).astype(np.int32)
    jl, jc = jb.slot_verify(jp, jnp.asarray(block), jc, jnp.asarray(active),
                            jcfg)
    tl, tc = tb.slot_verify(tp, _long(block), tc, active, tcfg)
    assert tl.shape == (3, 5, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["host_lengths"] == [12, 0, 17]
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


def test_inactive_rows_do_not_advance(tiny):
    """An inactive row keeps its length on the device and on the host, and
    the KV it holds below its frontier keeps every bit."""
    _, tcfg, _, tp, _ = tiny
    _, tc, _ = _prefilled(tiny, False)
    before = [tc[k][:, 2, :12].clone() for k in ("k", "v")]
    for _ in range(3):
        _, tc = tb.slot_decode(tp, _long([3, 4, 5]), tc, [True, False, False],
                               tcfg)
    assert tc["host_lengths"] == [10, 0, 12]
    assert tc["lengths"].tolist() == [10, 0, 12]
    for k, old in zip(("k", "v"), before):
        assert torch.equal(tc[k][:, 2, :12], old)


@pytest.mark.parametrize("quantized", [False, True])
def test_restore_after_slot_reuse_gives_the_stored_prefix(tiny, quantized):
    """The stored prefix is a copy: a new occupant of the slot does not
    change it, and restoring it then prefilling the rest gives the logits
    of a whole prefill of the prompt."""
    _, tcfg, _, tp, _ = tiny
    a, b = _prompts(8, (20, 14))
    tc = _cpu_cache(tcfg, 2, 48, quantized)
    want, tc = tb.slot_prefill(tp, _long(a)[None], tc, 0, tcfg)
    snap = [tc[k][:, 0, :16].clone() for k in tb._buf_keys(tc)]
    bufs = tb.slot_extract_kv(tc, 0, 16)
    _, tc = tb.slot_prefill(tp, _long(b)[None], tc, 0, tcfg)   # slot reused
    for buf, old in zip(bufs, snap):
        assert torch.equal(buf, old)
    tc = tb.slot_restore_kv(tc, 0, bufs, 16)
    assert tc["host_lengths"][0] == 16 and int(tc["lengths"][0]) == 16
    got, tc = tb.slot_prefill(tp, _long(a[16:])[None], tc, 0, tcfg,
                              append=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---- picking tokens ----------------------------------------------------------

LOGITS = np.array([
    [1.0, 5.0, 3.0, 5.0, 4.0, 4.0, 2.0, -1.0],
    [0.5, 0.5, 0.5, 0.5, 0.1, 0.1, 0.0, 2.0],
    [3.0, 1.0, 3.0, 3.0, -2.0, 0.0, 1.0, 1.0],
], np.float32)


@pytest.mark.parametrize("top_ks, top_ps", [
    ([0, 0, 0], [1.0, 1.0, 1.0]),
    ([1, 2, 3], [1.0, 1.0, 1.0]),
    ([0, 0, 0], [1e-6, 0.5, 0.9]),
    ([3, 0, 2], [0.7, 0.3, 0.99]),
    ([8, 5, 100], [0.5, 1.0, 0.6]),
])
def test_rowwise_filter_matches_jax(top_ks, top_ps):
    """Identical logits (with ties) give identical masks and values, for
    one position per row and for a [slots, T] block."""
    ks, ps = np.array(top_ks, np.int32), np.array(top_ps, np.float32)
    want = np.asarray(jb._rowwise_filter(jnp.asarray(LOGITS), jnp.asarray(ks),
                                         jnp.asarray(ps)))
    got = tb._rowwise_filter(torch.from_numpy(LOGITS), _long(ks),
                             torch.from_numpy(ps))
    np.testing.assert_array_equal(got.numpy(), want)
    block = np.random.default_rng(2).standard_normal((3, 4, 32)).astype(
        np.float32) * 3
    want = np.asarray(jb._rowwise_filter(jnp.asarray(block),
                                         jnp.asarray(ks)[:, None],
                                         jnp.asarray(ps)[:, None]))
    got = tb._rowwise_filter(torch.from_numpy(block), _long(ks)[:, None],
                             torch.from_numpy(ps)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)


def test_rowwise_pick_semantics():
    """The JAX test of rowwise_pick: greedy rows, top_k=1 = greedy at any
    temperature, top_k=4 inside the top 4, a tiny top_p = the argmax."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 32)).astype(np.float32) * 3.0)
    temps = torch.tensor([0.0, 1.0, 1.0])
    tks, tps = torch.tensor([0, 1, 4]), torch.tensor([1.0, 1.0, 1.0])
    greedy = logits.argmax(dim=-1)
    top4 = set(logits[2].topk(4).indices.tolist())
    for _ in range(20):
        out = tb.rowwise_pick(logits, temps, tks, tps, gen)
        assert out[0] == greedy[0] and out[1] == greedy[1]
        assert int(out[2]) in top4
    out = tb.rowwise_pick(logits, temps, torch.tensor([0, 0, 0]),
                          torch.tensor([1.0, 1.0, 1e-6]), gen)
    assert out[2] == greedy[2]


def test_rowwise_pick_repeats_per_seed():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 64)).astype(np.float32))
    args = (torch.tensor([1.0, 0.7, 1.3, 0.0]), torch.tensor([0, 16, 0, 0]),
            torch.tensor([1.0, 1.0, 0.9, 1.0]))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([tb.rowwise_pick(logits, *args, gen)
                            for _ in range(8)])

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))


def test_spec_accept_greedy_matches_jax():
    """Drafts that agree with the target's argmax for 0..g positions."""
    rng = np.random.default_rng(5)
    s, g, v = 5, 4, 32
    tlogits = rng.standard_normal((s, g + 1, v)).astype(np.float32)
    greedy = tlogits.argmax(-1)
    drafts = greedy[:, :g].copy()
    for row, keep in enumerate([0, 1, 2, 4, 3]):
        if keep < g:
            drafts[row, keep] = (drafts[row, keep] + 1) % v
    want_a, want_emit = jb.spec_accept_greedy(jnp.asarray(tlogits),
                                              jnp.asarray(drafts, jnp.int32))
    a, emit = tb.spec_accept_greedy(torch.from_numpy(tlogits), _long(drafts))
    assert a.tolist() == [0, 1, 2, 4, 3]
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(want_emit))


def test_rowwise_spec_accept_greedy_rows_and_a_draft_equal_to_the_target():
    """Greedy rows take the greedy acceptance; a sampling row whose draft
    distribution q equals the target's p accepts every proposal (u < 1)."""
    rng = np.random.default_rng(6)
    s, g, v = 3, 3, 16
    tlogits = torch.from_numpy(rng.standard_normal((s, g + 1, v)).astype(
        np.float32))
    drafts = torch.from_numpy(rng.integers(0, v, (s, g)))
    temps = torch.tensor([0.0, 0.8, 0.0])
    tks, tps = torch.tensor([0, 0, 0]), torch.tensor([1.0, 1.0, 1.0])
    tlp = torch.log_softmax(tb._rowwise_filter(
        tb._scaled(tlogits, temps), tks[:, None], tps[:, None]), dim=-1)
    dlogp = tlp[:, :g].transpose(0, 1)
    a, emit = tb.rowwise_spec_accept(tlogits, drafts, dlogp, temps, tks, tps,
                                     torch.Generator().manual_seed(0))
    a_g, emit_g = tb.spec_accept_greedy(tlogits, drafts)
    for row in (0, 2):
        assert a[row] == a_g[row] and torch.equal(emit[row], emit_g[row])
    assert a[1] == g and torch.equal(emit[1, :g], drafts[1])


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_multi_with_budgets(tiny, sampled):
    """A chunk of 5 steps with budgets 2 / 0 / 5: greedy, the JAX scan's
    tokens and lengths; a row past its budget stops advancing. Sampled with
    top_k=1 the rows pick the same greedy tokens."""
    jcfg, tcfg, jp, tp, _ = tiny
    jc, tc, _ = _prefilled(tiny, False)
    toks, active, remaining = [5, 0, 9], [True, False, True], [2, 0, 5]
    want, jc = jb.slot_decode_multi(
        jp, jnp.asarray(toks, jnp.int32), jc, jnp.asarray(active),
        jnp.asarray(remaining, jnp.int32), jcfg, 5)
    sample = None
    if sampled:
        sample = (torch.tensor([0.9, 0.0, 1.4]), torch.tensor([1, 0, 1]),
                  torch.tensor([1.0, 1.0, 1.0]), torch.Generator())
    got, tc = tb.slot_decode_multi(tp, _long(toks), tc, active, remaining,
                                   tcfg, 5, sample=sample)
    assert got.shape == (5, 3)
    np.testing.assert_array_equal(got[:2, 0].numpy(), np.asarray(want)[:2, 0])
    np.testing.assert_array_equal(got[:, 2].numpy(), np.asarray(want)[:, 2])
    assert tc["host_lengths"] == [9, 0, 17]
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


# ---- tests/test_batching.py, on the port -------------------------------------

def _port_greedy(logits):
    return logits.argmax(dim=-1)


def test_two_slots_match_solo_streams(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    p0, p1 = _prompts(11, (6, 9))
    want = [_jax_solo(jp, jcfg, p, 5) for p in (p0, p1)]
    cache = _cpu_cache(tcfg, 2, 32)
    l0, cache = tb.slot_prefill(tp, _long(p0)[None], cache, 0, tcfg)
    l1, cache = tb.slot_prefill(tp, _long(p1)[None], cache, 1, tcfg)
    toks = torch.cat([_port_greedy(l0), _port_greedy(l1)])
    streams = [[int(toks[0])], [int(toks[1])]]
    for _ in range(4):
        logits, cache = tb.slot_decode(tp, toks, cache, [True, True], tcfg)
        toks = _port_greedy(logits)
        streams[0].append(int(toks[0]))
        streams[1].append(int(toks[1]))
    assert streams == want


def test_staggered_admission_does_not_disturb_running_slot(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    p0, p1 = _prompts(12, (5, 7))
    want0, want1 = _jax_solo(jp, jcfg, p0, 6), _jax_solo(jp, jcfg, p1, 3)
    cache = _cpu_cache(tcfg, 2, 32)
    l0, cache = tb.slot_prefill(tp, _long(p0)[None], cache, 0, tcfg)
    s0 = [int(_port_greedy(l0))]
    for _ in range(2):
        logits, cache = tb.slot_decode(tp, _long([s0[-1], 0]), cache,
                                       [True, False], tcfg)
        s0.append(int(logits[0].argmax()))
    l1, cache = tb.slot_prefill(tp, _long(p1)[None], cache, 1, tcfg)
    s1 = [int(_port_greedy(l1))]
    for _ in range(3):
        logits, cache = tb.slot_decode(tp, _long([s0[-1], s1[-1]]), cache,
                                       [True, True], tcfg)
        s0.append(int(logits[0].argmax()))
        if len(s1) < 3:
            s1.append(int(logits[1].argmax()))
    assert s0 == want0 and s1 == want1


def test_slot_reuse_after_finish(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    p_old, p_new = _prompts(13, (10, 4))
    want = _jax_solo(jp, jcfg, p_new, 4)
    cache = _cpu_cache(tcfg, 1, 32)
    logits, cache = tb.slot_prefill(tp, _long(p_old)[None], cache, 0, tcfg)
    toks = _port_greedy(logits)
    for _ in range(3):                      # leave stale entries behind
        logits, cache = tb.slot_decode(tp, toks, cache, [True], tcfg)
        toks = _port_greedy(logits)
    logits, cache = tb.slot_prefill(tp, _long(p_new)[None], cache, 0, tcfg)
    toks = _port_greedy(logits)
    stream = [int(toks[0])]
    for _ in range(3):
        logits, cache = tb.slot_decode(tp, toks, cache, [True], tcfg)
        toks = _port_greedy(logits)
        stream.append(int(toks[0]))
    assert stream == want


def test_kv_quant_slot_cache_matches_generate(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    prompt = np.array([5, 9, 2, 7, 11, 3], np.int32)
    want = _jax_solo(jp, jcfg, prompt, 8, kv_quant=True)
    cache = _cpu_cache(tcfg, 2, 32, quantized=True)
    assert cache["k"].dtype == torch.int8 and "ks" in cache
    logits, cache = tb.slot_prefill(tp, _long(prompt)[None], cache, 1, tcfg)
    toks = [int(logits[0].argmax())]
    while len(toks) < 8:
        logits, cache = tb.slot_decode(tp, _long([0, toks[-1]]), cache,
                                       [False, True], tcfg)
        toks.append(int(logits[1].argmax()))
    assert toks == want


def test_kv_quant_slot_cache_independent_rows(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    prompts = [np.array([4, 8, 15], np.int32),
               np.array([16, 23, 42, 108, 7], np.int32)]
    wants = [_jax_solo(jp, jcfg, p, 6, kv_quant=True) for p in prompts]
    cache = _cpu_cache(tcfg, 2, 32, quantized=True)
    lg0, cache = tb.slot_prefill(tp, _long(prompts[0])[None], cache, 0, tcfg)
    lg1, cache = tb.slot_prefill(tp, _long(prompts[1])[None], cache, 1, tcfg)
    streams = [[int(lg0[0].argmax())], [int(lg1[0].argmax())]]
    while len(streams[0]) < 6:
        logits, cache = tb.slot_decode(
            tp, _long([streams[0][-1], streams[1][-1]]), cache,
            [True, True], tcfg)
        streams[0].append(int(logits[0].argmax()))
        streams[1].append(int(logits[1].argmax()))
    assert streams == wants


# ---- tests/test_spec_batch.py (dense cases), on the port ----------------------

def _run_batch(b, prompts, max_new, **submit_kw):
    """Submit all prompts concurrently; close the batcher first on exit
    (waiters are only woken by _fail_all)."""
    ex = ThreadPoolExecutor(len(prompts))
    try:
        futs = [ex.submit(b.submit, _long(p), max_new, **submit_kw)
                for p in prompts]
        return [f.result(timeout=180) for f in futs]
    finally:
        b.close()
        ex.shutdown(wait=True)


def test_spec_greedy_streams_exact_with_bad_draft(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    prompts = _prompts(21, (6, 9, 5))
    want = [_jax_solo(jp, jcfg, p, 12) for p in prompts]
    b = _Batcher(tcfg, tp, slots=3, max_len=64, draft=(tcfg, draft), gamma=4)
    assert _run_batch(b, prompts, 12) == want
    assert b.spec_rounds >= 1
    assert b.spec_emitted >= 3 * 11         # all but the arm token


def test_spec_perfect_draft_accepts_everything(tiny):
    jcfg, tcfg, jp, tp, _ = tiny
    (p,) = _prompts(22, (7,))
    b = _Batcher(tcfg, tp, slots=1, max_len=64, draft=(tcfg, tp), gamma=3)
    assert _run_batch(b, [p], 13) == [_jax_solo(jp, jcfg, p, 13)]
    # 13 tokens = 1 (arm) + 12 from rounds of gamma+1 = 4 -> 3 rounds
    assert b.spec_rounds == 3
    assert b.spec_accepted == 3 * 3


@pytest.mark.parametrize("gamma", [1, 2, 5])
def test_spec_exact_across_gamma(tiny, gamma):
    jcfg, tcfg, jp, tp, draft = tiny
    prompts = _prompts(23, (6, 8))
    b = _Batcher(tcfg, tp, slots=2, max_len=64, draft=(tcfg, draft),
                 gamma=gamma)
    assert _run_batch(b, prompts, 9) == [_jax_solo(jp, jcfg, p, 9)
                                          for p in prompts]


def test_spec_staggered_admission_joins_between_rounds(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    p0, p1 = _prompts(24, (5, 7))
    b = _Batcher(tcfg, tp, slots=2, max_len=64, draft=(tcfg, draft), gamma=4)
    ex = ThreadPoolExecutor(2)
    try:
        f0 = ex.submit(b.submit, _long(p0), 16)
        while b.spec_rounds < 1 and not f0.done():
            threading.Event().wait(0.005)
        f1 = ex.submit(b.submit, _long(p1), 8)
        got = [f0.result(timeout=180), f1.result(timeout=180)]
    finally:
        b.close()
        ex.shutdown(wait=True)
    assert got == [_jax_solo(jp, jcfg, p0, 16), _jax_solo(jp, jcfg, p1, 8)]


def test_spec_with_kv_quant(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    prompts = _prompts(25, (6, 9))
    b = _Batcher(tcfg, tp, slots=2, max_len=64, kv_quant=True,
                 draft=(tcfg, draft), gamma=3)
    assert _run_batch(b, prompts, 10) == [
        _jax_solo(jp, jcfg, p, 10, kv_quant=True) for p in prompts]


def test_spec_with_chunked_prefill(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    prompts = _prompts(26, (13, 6))
    b = _Batcher(tcfg, tp, slots=2, max_len=64, prefill_chunk=4,
                 draft=(tcfg, draft), gamma=3)
    assert _run_batch(b, prompts, 8) == [_jax_solo(jp, jcfg, p, 8)
                                         for p in prompts]


def test_spec_with_prefix_cache(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    (p,) = _prompts(27, (12,))
    want = _jax_solo(jp, jcfg, p, 8)
    b = _Batcher(tcfg, tp, slots=1, max_len=64, prefix_cache=2,
                 draft=(tcfg, draft), gamma=3)
    try:
        got = [b.submit(_long(p), 8), b.submit(_long(p), 8)]
    finally:
        b.close()
    assert got == [want, want]
    assert b.prefix_hits >= 1


def test_spec_mixed_greedy_and_sampling_rows(tiny):
    jcfg, tcfg, jp, tp, draft = tiny
    pg, ps = _prompts(28, (6, 7))
    b = _Batcher(tcfg, tp, slots=2, max_len=64, draft=(tcfg, draft), gamma=4,
                 seed=7)
    ex = ThreadPoolExecutor(2)
    try:
        fg = ex.submit(b.submit, _long(pg), 12)
        fs = ex.submit(b.submit, _long(ps), 12, temperature=0.9, top_k=8)
        got_g, got_s = fg.result(timeout=180), fs.result(timeout=180)
    finally:
        b.close()
        ex.shutdown(wait=True)
    assert got_g == _jax_solo(jp, jcfg, pg, 12)
    assert len(got_s) == 12 and all(0 <= t < 256 for t in got_s)


def test_spec_sampling_reproducible_with_seed(tiny):
    _, tcfg, _, tp, draft = tiny
    (p,) = _prompts(29, (6,))

    def once():
        b = _Batcher(tcfg, tp, slots=1, max_len=64, draft=(tcfg, draft),
                     gamma=3, seed=123)
        try:
            return b.submit(_long(p), 10, temperature=0.8)
        finally:
            b.close()

    assert once() == once()


def test_spec_sampling_distribution_matches_target():
    """The second emitted token (always from a spec round) against the
    exact target marginal, as the JAX test: a 16-token vocab and a draft
    head sharpened far from the target."""
    cfg = tllama.LlamaConfig(vocab_size=16, d_model=32, n_layers=2,
                             n_heads=2, n_kv_heads=1, d_ff=64, max_seq_len=64,
                             dtype=torch.float32)
    target = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    draft = tllama.init_params(cfg, torch.Generator().manual_seed(42))
    draft = dict(draft, lm_head=draft["lm_head"] * 8.0)
    temp = 0.9
    prompt = torch.tensor([3, 7, 1, 9])

    def dist(params, tokens):
        logits, _ = ti.prefill(params, tokens[None],
                               ti.init_cache(cfg, 1, 32, device="cpu"), cfg)
        return torch.softmax(logits / temp, dim=-1)[0].double()

    p0 = dist(target, prompt)
    exact = sum(p0[t] * dist(target, torch.cat([prompt, torch.tensor([t])]))
                for t in range(16))
    n = 600
    counts = torch.zeros(16, dtype=torch.float64)
    b = _Batcher(cfg, target, slots=1, max_len=64, draft=(cfg, draft),
                 gamma=3, seed=9)
    try:
        for _ in range(n):
            counts[b.submit(prompt, 2, temperature=temp)[1]] += 1
    finally:
        b.close()
    tv = 0.5 * float((counts / n - exact).abs().sum())
    assert tv < 0.15, f"TV {tv:.3f} vs exact target marginal (n={n})"
    # power check: the draft's own marginal is far from the target's
    assert 0.5 * float((dist(draft, prompt) - p0).abs().sum()) > 0.3


def test_spec_vocab_mismatch_refused(tiny):
    import dataclasses
    _, tcfg, _, tp, draft = tiny
    dcfg = dataclasses.replace(tcfg, vocab_size=tcfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        _Batcher(tcfg, tp, slots=1, max_len=64, draft=(dcfg, draft))
