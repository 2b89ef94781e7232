"""PyTorch port, infer.py: the static KV cache, prefill / decode_step,
generate and speculative_generate against the JAX package on the same
weights (converted from the JAX init) and the same tokens, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import infer as ji
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.train import tree_map

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params, draft pair,
    prompt [2, 8] int32)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    dtree = jax.tree.map(np.asarray,
                         jllama.init_params(jcfg, jax.random.key(42)))
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg),
            (jax.tree.map(jnp.asarray, dtree),
             convert.params_from_numpy(dtree, tcfg)), prompt)


def _long(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.mark.parametrize("quantized", [False, True])
def test_init_cache_shapes_and_dtypes(quantized):
    cfg = tllama.LlamaConfig.tiny()
    got = ti.init_cache(cfg, 2, 32, quantized=quantized, device="cpu")
    want = ji.init_cache(jllama.LlamaConfig.tiny(), 2, 32, quantized=quantized)
    assert set(got) == set(want)
    for name in want:
        if name == "host_length":
            assert got[name] == want[name] == 0
            continue
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_init_cache_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ti.init_cache(tllama.LlamaConfig.tiny(), 1, 8)


def _attend_inputs(seed, b, t, s_max, quantized):
    rng = np.random.default_rng(seed)
    h, hkv, d = 4, 2, 16
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    if not quantized:
        return q, k, v, None, None
    kq, ks = (np.asarray(x) for x in ji._quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in ji._quantize_kv(jnp.asarray(v)))
    return q, kq, vq, ks, vs


ATTEND_CASES = {
    "scalar pos": dict(pos=37, t=1),
    "scalar pos, 4 queries": dict(pos=20, t=4),
    "per-row pos": dict(pos=[5, 60], t=1),
    "per-row pos, active": dict(pos=[0, 44], t=1, active=[False, True]),
    "window": dict(pos=70, t=2, window=24),
    "per-row pos, active, window": dict(pos=[3, 80], t=1, window=16,
                                        active=[False, True]),
    "int8 scales": dict(pos=50, t=1, quantized=True),
    "int8 scales, per-row pos, window": dict(pos=[30, 90], t=1, window=40,
                                             quantized=True),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_cached_matches_jax(case):
    kw = dict(ATTEND_CASES[case])
    pos, t = kw.pop("pos"), kw.pop("t")
    window, active = kw.pop("window", 0), kw.pop("active", None)
    b = len(pos) if isinstance(pos, list) else 2
    q, k, v, ks, vs = _attend_inputs(sorted(ATTEND_CASES).index(case), b, t,
                                     96,
                                     kw.pop("quantized", False))
    jpos = jnp.asarray(pos, jnp.int32)
    want = ji._attend_cached(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos,
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), window=window,
        active=None if active is None else jnp.asarray(active))
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    got = ti._attend_cached(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), tpos,
        None if ks is None else torch.tensor(ks),
        None if vs is None else torch.tensor(vs), window=window,
        active=None if active is None else torch.tensor(active))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos, t", [(5, 1), (40, 3), (63, 1)])
def test_attend_cached_never_reads_past_the_frontier(pos, t):
    """K/V past the blocks the frontier reaches, filled with NaN, leave the
    output finite and bit for bit unchanged: those columns are not read."""
    s_max = 96                     # blocks of 32
    q, k, v, _, _ = _attend_inputs(pos, 2, t, s_max, False)
    blk = ti._block_for(s_max)
    used = ti.blocks_used(pos, t, blk) * blk
    assert used < s_max
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    clean = ti._attend_cached(q, k, v, pos)
    k[:, used:], v[:, used:] = float("nan"), float("nan")
    poisoned = ti._attend_cached(q, k, v, pos)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(poisoned, clean)


def test_blocks_used_and_block_size_match_jax():
    for s_max in (4096, 96, 7, 289):
        assert ti._block_for(s_max) == ji._block_for(s_max)
    for pos in (0, 127, 128, 4000):
        assert ti.blocks_used(pos, 1, 128) == int(ji.blocks_used(pos, 1, 128))


@pytest.mark.parametrize("pos", [3, [0, 5], [2, 30]])
def test_cache_write_matches_jax(pos):
    """Scalar and per-row starts; a per-row start past S_max - T clamps,
    as lax.dynamic_update_slice does."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 32, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    want = ji._cache_write(jnp.asarray(cache), jnp.asarray(new),
                           jnp.asarray(pos, jnp.int32))
    tcache = torch.from_numpy(cache.copy())
    got = ti._cache_write(tcache, torch.from_numpy(new),
                          torch.tensor(pos) if isinstance(pos, list) else pos)
    assert got is tcache
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_steps_match_jax(tiny):
    jcfg, tcfg, jp, tp, _, prompt = tiny
    jcache = ji.init_cache(jcfg, 2, 16)
    tcache = ti.init_cache(tcfg, 2, 16, device="cpu")
    want, jcache = ji.prefill(jp, jnp.asarray(prompt), jcache, jcfg)
    got, tcache = ti.prefill(tp, _long(prompt), tcache, tcfg)
    assert got.shape == (2, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache["host_length"] == 8 and int(tcache["length"]) == 8
    for _ in range(4):
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        want, jcache = ji.decode_step(jp, jnp.asarray(tok), jcache, jcfg)
        got, tcache = ti.decode_step(tp, _long(tok), tcache, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache["host_length"] == int(jcache["length"]) == 12


def test_prefill_matches_the_full_forward(tiny):
    _, tcfg, _, tp, _, prompt = tiny
    got, _ = ti.prefill(tp, _long(prompt),
                        ti.init_cache(tcfg, 2, 16, device="cpu"), tcfg)
    full = tllama.llama_forward(tp, _long(prompt), tcfg, impl="xla")
    torch.testing.assert_close(got, full[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_quant, max_new", [(False, 1), (False, 8),
                                                (True, 1), (True, 8)])
def test_generate_greedy_matches_jax(tiny, kv_quant, max_new):
    jcfg, tcfg, jp, tp, _, prompt = tiny
    want = np.asarray(ji.generate(jp, jnp.asarray(prompt), jcfg, max_new,
                                  kv_quant=kv_quant))
    got = ti.generate(tp, _long(prompt), tcfg, max_new, kv_quant=kv_quant)
    assert got.shape == (2, max_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_overflow_raises(tiny):
    _, tcfg, _, tp, _, prompt = tiny
    cache = ti.init_cache(tcfg, 2, 9, device="cpu")   # room for prompt + 1
    logits, cache = ti.prefill(tp, _long(prompt), cache, tcfg)
    tok = logits.argmax(dim=-1)
    _, cache = ti.decode_step(tp, tok, cache, tcfg)     # fills slot 9/9
    with pytest.raises(ValueError, match="overflow"):
        ti.decode_step(tp, tok, cache, tcfg)
    with pytest.raises(ValueError, match="overflow"):
        ti.prefill(tp, _long(prompt), ti.init_cache(tcfg, 2, 4, device="cpu"),
                   tcfg)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_writes_the_cache_in_place(tiny, quantized):
    _, tcfg, _, tp, _, prompt = tiny
    cache = ti.init_cache(tcfg, 2, 16, quantized=quantized, device="cpu")
    _, cache = ti.prefill(tp, _long(prompt), cache, tcfg)
    before = {k: (v.data_ptr(), v.clone()) for k, v in cache.items()
              if k in ("k", "v", "ks", "vs")}
    _, out = ti.decode_step(tp, torch.tensor([3, 4]), cache, tcfg)
    assert out["host_length"] == 9
    for name, (ptr, old) in before.items():
        assert out[name].data_ptr() == ptr, name          # same storage
        assert not torch.equal(out[name][:, :, 8], old[:, :, 8]), name
        assert torch.equal(out[name][:, :, :8], old[:, :, :8]), name


def test_outputs_carry_no_graph_with_requires_grad_weights(tiny):
    _, tcfg, _, tp, _, prompt = tiny
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    cache = ti.init_cache(tcfg, 2, 16, device="cpu")
    logits, cache = ti.prefill(params, _long(prompt), cache, tcfg)
    logits2, cache = ti.decode_step(params, logits.argmax(dim=-1), cache, tcfg)
    toks = ti.generate(params, _long(prompt), tcfg, 3, kv_quant=True)
    for t in (logits, logits2, toks, cache["k"], cache["v"]):
        assert t.grad_fn is None and not t.requires_grad


LOGITS_WITH_TIES = np.array([
    [1.0, 5.0, 3.0, 5.0, 4.0, 4.0, 2.0, -1.0],
    [0.5, 0.5, 0.5, 0.5, 0.1, 0.1, 0.0, 2.0],
    [3.0, 1.0, 3.0, 3.0, -2.0, 0.0, 1.0, 1.0],
], np.float32)


@pytest.mark.parametrize("top_k", [1, 2, 3, 5])
def test_filter_top_k_matches_jax(top_k):
    want = np.asarray(ji._filter_top_k(jnp.asarray(LOGITS_WITH_TIES), top_k))
    got = ti._filter_top_k(torch.from_numpy(LOGITS_WITH_TIES), top_k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_p", [1e-6, 0.3, 0.5, 0.7, 0.9, 0.99])
def test_filter_top_p_matches_jax(top_p):
    """The cutoff is a logit: every token tied with the last one inside
    the nucleus is kept, as in the JAX version."""
    want = np.asarray(ji._filter_top_p(jnp.asarray(LOGITS_WITH_TIES), top_p))
    got = ti._filter_top_p(torch.from_numpy(LOGITS_WITH_TIES), top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_top_k_1_is_greedy(tiny):
    _, tcfg, _, tp, _, prompt = tiny
    greedy = ti.generate(tp, _long(prompt), tcfg, 6)
    topk1 = ti.generate(tp, _long(prompt), tcfg, 6, temperature=1.3, top_k=1,
                        generator=torch.Generator().manual_seed(42))
    assert torch.equal(greedy, topk1)


def test_sampled_tokens_stay_in_the_top_k_and_repeat_per_seed(tiny):
    _, tcfg, _, tp, _, prompt = tiny
    k = 3

    def sample(seed):
        return ti.generate(tp, _long(prompt), tcfg, 8, temperature=1.0,
                           top_k=k, generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # teacher-forced logits at each sampled position: the token is among
    # the k highest
    seq = torch.cat([_long(prompt), a[:, :-1]], dim=1)
    logits = tllama.llama_forward(tp, seq, tcfg, impl="xla")[:, 7:]
    kth = logits.topk(k, dim=-1).values[..., -1]
    picked = logits.gather(-1, a[..., None])[..., 0]
    assert bool((picked >= kth).all())


def test_speculative_greedy_is_the_target_stream_and_matches_jax(tiny):
    jcfg, tcfg, jp, tp, (jdraft, tdraft), prompt = tiny
    p1 = prompt[:1]
    target_only = ti.generate(tp, _long(p1), tcfg, 12)
    want, _ = ji.speculative_generate(jp, jdraft, jnp.asarray(p1), jcfg, jcfg,
                                      12, gamma=4)
    got, stats = ti.speculative_generate(tp, tdraft, _long(p1), tcfg, tcfg,
                                         12, gamma=4)
    assert torch.equal(got, target_only)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] >= 1
    # with the target as its own draft every proposal is accepted and the
    # a == gamma fill step runs every round
    got, stats = ti.speculative_generate(tp, tp, _long(p1), tcfg, tcfg, 12,
                                         gamma=3)
    assert torch.equal(got, target_only)
    assert stats == {"rounds": 3, "accepted": 9}


def test_speculative_greedy_with_kv_quant_matches_jax(tiny):
    jcfg, tcfg, jp, tp, (jdraft, tdraft), prompt = tiny
    p1 = prompt[1:]
    want, _ = ji.speculative_generate(jp, jdraft, jnp.asarray(p1), jcfg, jcfg,
                                      10, gamma=2, kv_quant=True)
    got, _ = ti.speculative_generate(tp, tdraft, _long(p1), tcfg, tcfg, 10,
                                     gamma=2, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ti.generate(tp, _long(p1), tcfg, 10,
                                        kv_quant=True))


def test_speculative_sampling_repeats_per_seed_and_stays_in_range(tiny):
    _, tcfg, _, tp, (_, tdraft), prompt = tiny

    def run(seed):
        return ti.speculative_generate(
            tp, tdraft, _long(prompt[:1]), tcfg, tcfg, 10, gamma=3,
            temperature=0.8, top_k=20, top_p=0.9, kv_quant=True,
            generator=torch.Generator().manual_seed(seed))

    (a, sa), (b, _) = run(5), run(5)
    assert torch.equal(a, b) and a.shape == (1, 10)
    assert bool(((a >= 0) & (a < tcfg.vocab_size)).all())
    assert sa["rounds"] >= 1
    with pytest.raises(ValueError, match="B=1"):
        ti.speculative_generate(tp, tdraft, _long(prompt), tcfg, tcfg, 4)
