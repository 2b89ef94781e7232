"""PyTorch port, paging.py: the block pool's init, prefill (fresh and
append), decode with an inactive row, verify across a block edge, the kv8
pools, the decode chunk, the KV export and import, and the host-side
BlockAllocator, PrefixTrie (batching.py) and kvaffinity, against the JAX
package on the same tiny weights (converted from the JAX init), the same
pools, page tables and lengths, and the same numpy-seeded tokens, on the
CPU."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import batching as jb
from gpu_docker_api_tpu import kvaffinity as jaff
from gpu_docker_api_tpu import paging as jp
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu_torch import batching as tb
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import kvaffinity as taff
from gpu_docker_api_tpu_torch import paging as tp
from gpu_docker_api_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

# the dense twins' tolerance (tests/test_torch_batching.py): f32 logits and
# pools agree up to f32 summation order
TOL = dict(rtol=1e-5, atol=1e-5)
# int8 pools: an element may differ by 1 where the f32 value before
# rounding sits on a tie, at most this many elements a buffer
INT8_TIES = 4

BLK, N_BLOCKS, MAX_PAGES = 4, 20, 6
# page tables of three slots, written the same on both sides: row 1 is
# short, rows 0 and 2 run over non-contiguous blocks
ROWS = {0: [3, 7, 1, 9], 1: [2, 5], 2: [11, 4, 6, 8, 12]}


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg))


def _long(a):
    return torch.from_numpy(np.array(a)).long()


def _pools(jcfg, tcfg, quantized):
    """A JAX and a port pool with ROWS written into both page tables."""
    jc = jp.init_paged_cache(jcfg, N_BLOCKS, BLK, 3, MAX_PAGES,
                             quantized=quantized)
    tc = tp.init_paged_cache(tcfg, N_BLOCKS, BLK, 3, MAX_PAGES,
                             quantized=quantized, device="cpu")
    for slot, row in ROWS.items():
        padded = row + [0] * (MAX_PAGES - len(row))
        jc["pages"] = jc["pages"].at[slot].set(jnp.array(padded, jnp.int32))
        tp.set_pages(tc, slot, row)
    return jc, tc


def _assert_pools(tc, jc):
    """Every pool and scale buffer, block 0 (scratch) aside; int8 pools up
    to INT8_TIES rounding ties."""
    for name in ("k", "v", "ks", "vs"):
        if name not in jc:
            continue
        got = tc[name].numpy()[:, 1:]
        want = np.asarray(jc[name])[:, 1:]
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).sum() <= INT8_TIES, name
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def _filled(tiny, quantized, seed=0):
    """Pools with slot 0 prefilled 7 tokens, slot 2 5 tokens then 6 more
    (append), slot 1 idle; returns (jc, tc, [(jax logits, port logits)])."""
    jcfg, tcfg, jpar, tpar = tiny
    jc, tc = _pools(jcfg, tcfg, quantized)
    rng = np.random.default_rng(seed)
    pairs = []
    for slot, n, append in ((0, 7, False), (2, 5, False), (2, 6, True)):
        p = rng.integers(0, 256, n).astype(np.int32)
        jl, jc = jp.paged_prefill(jpar, jnp.asarray(p)[None], jc,
                                  jnp.int32(slot), jcfg, append=append)
        tl, tc = tp.paged_prefill(tpar, _long(p)[None], tc, slot, tcfg,
                                  append=append)
        pairs.append((jl, tl))
    return jc, tc, pairs


# ---- the pool and its steps, against the JAX functions ----------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_init_paged_cache_matches_jax(quantized):
    got = tp.init_paged_cache(tllama.LlamaConfig.tiny(), 9, 4, 3, 5,
                              quantized=quantized, device="cpu")
    want = jp.init_paged_cache(jllama.LlamaConfig.tiny(), 9, 4, 3, 5,
                               quantized=quantized)
    assert set(got) == set(want) | {"host_lengths", "host_pages"}
    assert got["host_lengths"] == [0, 0, 0]
    assert got["host_pages"] == [[0] * 5] * 3
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_init_paged_cache_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.init_paged_cache(tllama.LlamaConfig.tiny(), 4, 4, 1, 2)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_fresh_and_append_match_jax(tiny, quantized):
    jc, tc, pairs = _filled(tiny, quantized)
    assert len(pairs) == 3
    for jl, tl in pairs:
        assert tl.shape == (1, 256) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["host_lengths"] == [7, 0, 11]
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    _assert_pools(tc, jc)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_with_an_inactive_row_matches_jax(tiny, quantized):
    """Rows 0 and 2 decode, row 1 sits out (its write goes to scratch): the
    logits of every row, the lengths, the pools, step by step."""
    jcfg, tcfg, jpar, tpar = tiny
    jc, tc, _ = _filled(tiny, quantized)
    active = [True, False, True]
    toks = np.array([5, 0, 9], np.int32)
    for _ in range(4):                   # row 2 crosses into its 4th block
        jl, jc = jp.paged_decode(jpar, jnp.asarray(toks), jc,
                                 jnp.asarray(active), jcfg)
        tl, tc = tp.paged_decode(tpar, _long(toks), tc, active, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tc["host_lengths"] == [11, 0, 15]
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    _assert_pools(tc, jc)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_verify_across_a_block_edge_matches_jax(tiny, quantized):
    """A [slots, 5] block appended at each row's frontier: row 0 (at 7)
    writes positions 7..11 over blocks 1 and 2 of its table, row 2 (at 11)
    positions 11..15; row 1 is inactive."""
    jcfg, tcfg, jpar, tpar = tiny
    jc, tc, _ = _filled(tiny, quantized)
    blocks = np.random.default_rng(4).integers(0, 256, (3, 5)).astype(np.int32)
    active = [True, False, True]
    jl, jc = jp.paged_verify(jpar, jnp.asarray(blocks), jc,
                             jnp.asarray(active), jcfg)
    tl, tc = tp.paged_verify(tpar, _long(blocks), tc, active, tcfg)
    assert tl.shape == (3, 5, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["host_lengths"] == [12, 0, 16]
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    _assert_pools(tc, jc)


def test_paged_decode_multi_and_pick_match_jax(tiny):
    """The decode chunk (row 2's budget ends mid-chunk) and the on-device
    pick, greedy rows, against the JAX twins."""
    jcfg, tcfg, jpar, tpar = tiny
    jc, tc, _ = _filled(tiny, False)
    active = [True, False, True]
    toks = np.array([5, 0, 9], np.int32)
    jsteps, jc = jp.paged_decode_multi(
        jpar, jnp.asarray(toks), jc, jnp.asarray(active),
        jnp.array([5, 0, 2], jnp.int32), jcfg, 5)
    tsteps, tc = tp.paged_decode_multi(tpar, _long(toks), tc, active,
                                       [5, 0, 2], tcfg, 5)
    got, want = tsteps.numpy(), np.asarray(jsteps)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:2, 2], want[:2, 2])
    assert tc["host_lengths"] == [12, 0, 13]
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    zeros = (jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.int32),
             jnp.ones(3, jnp.float32))
    jpick, jc = jp.paged_decode_pick(jpar, jnp.asarray(toks), jc,
                                     jnp.asarray(active), *zeros,
                                     jax.random.key(0), jcfg)
    tpick, tc = tp.paged_decode_pick(
        tpar, _long(toks), tc, active, torch.zeros(3), torch.zeros(3).long(),
        torch.ones(3), torch.Generator().manual_seed(0), tcfg)
    np.testing.assert_array_equal(tpick.numpy()[[0, 2]],
                                  np.asarray(jpick)[[0, 2]])
    _assert_pools(tc, jc)


def test_paged_stream_equals_the_dense_generate(tiny):
    """A slot decoded through the paged primitives over non-contiguous
    blocks streams infer.generate's greedy tokens (tests/test_paging.py's
    primitive check)."""
    from gpu_docker_api_tpu_torch import infer as ti
    _, tcfg, _, tpar = tiny
    prompt = _long([[5, 9, 2, 7, 11, 3]])
    want = ti.generate(tpar, prompt, tcfg, 8)[0].tolist()
    tc = tp.init_paged_cache(tcfg, 16, 4, 2, 8, device="cpu")
    alloc = tp.BlockAllocator(16)
    alloc.alloc(3)                       # the slot's pages are not contiguous
    tp.set_pages(tc, 1, alloc.alloc(4))
    logits, tc = tp.paged_prefill(tpar, prompt, tc, 1, tcfg)
    toks = [int(logits[0].argmax())]
    while len(toks) < 8:
        logits, tc = tp.paged_decode(tpar, _long([0, toks[-1]]), tc,
                                     [False, True], tcfg)
        toks.append(int(logits[1].argmax()))
    assert toks == want


def test_paged_prefill_past_the_page_table_raises(tiny):
    _, tcfg, _, tpar = tiny
    tc = tp.init_paged_cache(tcfg, 8, 4, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="paged KV overflow"):
        tp.paged_prefill(tpar, _long([list(range(9))]), tc, 0, tcfg)


def test_set_pages_keeps_the_host_mirror(tiny):
    _, tcfg, _, _ = tiny
    tc = tp.init_paged_cache(tcfg, 8, 4, 2, 3, device="cpu")
    tp.set_pages(tc, 1, [5, 2])
    tp.set_pages(tc, 0, [7])
    assert tc["host_pages"] == [[7, 0, 0], [5, 2, 0]]
    assert tc["pages"].tolist() == tc["host_pages"]


# ---- the KV handoff's export and import ---------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_extract_matches_jax_and_injects_back(tiny, quantized):
    """The export of a slot's blocks: float32 and int8 only, the JAX
    export's names, shapes and dtypes, values within TOL (int8 up to
    ties); written into other blocks of a fresh pool, it reads back
    exactly."""
    jc, tc, _ = _filled(tiny, quantized)
    ids = ROWS[2][:3]
    got = tp.paged_extract_blocks(tc, ids)
    want = jp.paged_extract_blocks(jc, ids)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].dtype.name in ("float32", "int8")
        assert got[name].shape == want[name].shape
        assert got[name].shape[1:3] == (3, BLK)
        if got[name].dtype.name == "int8":
            assert np.abs(got[name].astype(np.int32)
                          - want[name].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got[name], want[name], **TOL)
    fresh = tp.init_paged_cache(tllama.LlamaConfig.tiny(), N_BLOCKS, BLK, 3,
                                MAX_PAGES, quantized=quantized, device="cpu")
    tp.paged_inject_blocks(fresh, [13, 14, 15], got)
    again = tp.paged_extract_blocks(fresh, [13, 14, 15])
    for name in got:
        np.testing.assert_array_equal(again[name], got[name])


def test_bf16_pools_travel_as_float32_exactly():
    """A bf16 pool goes out as float32 (no bfloat16 numpy type on the
    wire) and comes back bit for bit."""
    import dataclasses
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.bfloat16)
    tc = tp.init_paged_cache(cfg, 6, 4, 1, 3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for name in ("k", "v"):
        tc[name].copy_(torch.randn(tc[name].shape, generator=gen))
    out = tp.paged_extract_blocks(tc, [2, 5])
    assert {a.dtype.name for a in out.values()} == {"float32"}
    back = tp.init_paged_cache(cfg, 6, 4, 1, 3, device="cpu")
    tp.paged_inject_blocks(back, [1, 3], out)
    for name in ("k", "v"):
        assert torch.equal(back[name][:, [1, 3]], tc[name][:, [2, 5]])


@pytest.mark.parametrize("bad", ["shape", "missing"])
def test_inject_refuses_a_mismatched_export_and_writes_nothing(tiny, bad):
    _, tc, _ = _filled(tiny, False)
    bufs = tp.paged_extract_blocks(tc, [3, 7])
    if bad == "shape":
        bufs["v"] = bufs["v"][:, :1]
        err = ValueError
    else:
        del bufs["v"]
        err = KeyError
    before = {k: tc[k].clone() for k in ("k", "v")}
    with pytest.raises(err):
        tp.paged_inject_blocks(tc, [13, 14], bufs)
    for k in before:
        assert torch.equal(tc[k], before[k])


# ---- the host-side structures, against the JAX classes ----------------------

def test_block_allocator_bookkeeping():
    a = tp.BlockAllocator(5)             # blocks 1..4 allocatable
    assert a.free_blocks == 4
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.alloc(2) is None            # only 1 left
    assert a.free_blocks == 1
    a.free(got)
    assert a.free_blocks == 4
    with pytest.raises(ValueError):
        tp.BlockAllocator(1)


@pytest.mark.parametrize("seed", range(3))
def test_block_allocator_and_trie_follow_the_jax_classes(seed):
    """One random sequence of operations on both packages' allocators and
    tries: every output, every free count, every length, equal at every
    step, the refused operations included."""
    rng = random.Random(seed)
    ours, theirs = tp.BlockAllocator(24), jp.BlockAllocator(24)
    trie_o, trie_t = tb.PrefixTrie(4), jb.PrefixTrie(4)
    live = []
    keys = [[rng.randrange(6) for _ in range(rng.randrange(4, 20))]
            for _ in range(8)]
    for _ in range(200):
        op = rng.choice(["alloc", "share", "free", "bad", "insert", "lookup",
                         "evict", "leaves"])
        if op == "alloc":
            n = rng.randrange(1, 6)
            got = ours.alloc(n)
            assert got == theirs.alloc(n)
            if got:
                live.append(got)
        elif op == "share" and live:
            blocks = rng.choice(live)
            ours.share(blocks)
            theirs.share(blocks)
            live.append(list(blocks))
        elif op == "free" and live:
            blocks = live.pop(rng.randrange(len(live)))
            ours.free(blocks)
            theirs.free(blocks)
        elif op == "bad":
            dead = [b for b in range(1, 24) if b not in
                    {x for blocks in live for x in blocks}]
            if dead:
                for alloc in (ours, theirs):
                    with pytest.raises(RuntimeError, match="double free"):
                        alloc.free([dead[0]])
                    with pytest.raises(RuntimeError, match="sharing dead"):
                        alloc.share([dead[0]])
        elif op == "insert":
            key = rng.choice(keys)
            blocks = [rng.randrange(1, 24) for _ in range(len(key) // 4)]
            assert trie_o.insert(key, blocks) == trie_t.insert(key, blocks)
        elif op == "lookup":
            key = rng.choice(keys) + [rng.randrange(6)]
            assert trie_o.lookup(key) == trie_t.lookup(key)
        elif op == "evict":
            assert trie_o.evict_lru() == trie_t.evict_lru()
        elif op == "leaves":
            assert (sorted(trie_o.iter_leaf_prefixes())
                    == sorted(trie_t.iter_leaf_prefixes()))
        assert ours.free_blocks == theirs.free_blocks
        assert len(trie_o) == len(trie_t)
        assert trie_o.leaf_count == trie_t.leaf_count
    assert sorted(trie_o.clear()) == sorted(trie_t.clear())
    assert len(trie_o) == 0


def test_prefix_trie_sharing_lru_and_leaf_only_eviction():
    """tests/test_kv_routing.py's trie test, on the port's class."""
    t = tb.PrefixTrie(4)
    a = list(range(8))
    assert t.insert(a, [10, 11]) == [10, 11]
    b = a[:4] + [99, 98, 97, 96]
    assert t.insert(b, [10, 12]) == [12]     # the shared block is not new
    assert len(t) == 3 and t.leaf_count == 2
    blocks, matched = t.lookup(a + [5])
    assert blocks == [10, 11] and matched == 8
    assert t.evict_lru() == [12]             # b's leaf, the LRU one
    assert t.evict_lru() == [11]
    assert t.clear() == [10]
    with pytest.raises(ValueError):
        tb.PrefixTrie(0)


@pytest.mark.parametrize("seed", range(4))
def test_kvaffinity_bits_equal_the_jax_modules(seed):
    """A gateway scores JAX and port replicas with one decoder: the chunk
    hashes, the sketch words and the header hex are the JAX module's for
    random prompts (short, long, at the level cap, huge token ids)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 2 ** 31, n).tolist()
               for n in (0, 31, 32, 95, 256, 300, 1000)]
    for p in prompts:
        assert taff.chunk_hashes(p) == jaff.chunk_hashes(p)
        assert taff.chunk_hashes(p, chunk=16, levels=3) == jaff.chunk_hashes(
            p, chunk=16, levels=3)
    hashes = [h for p in prompts for h in taff.chunk_hashes(p)]
    words = taff.build_sketch(hashes)
    assert words == jaff.build_sketch(hashes)
    text = taff.encode_sketch_hex(words)
    assert text == jaff.encode_sketch_hex(words)
    assert taff.decode_sketch_hex(text) == jaff.decode_sketch_hex(text)
    assert [taff.signed64(w) for w in words] == [jaff.signed64(w)
                                                 for w in words]
    for p in prompts:
        h = taff.chunk_hashes(p)
        assert taff.hit_tokens(words, h) == jaff.hit_tokens(words, h)
        assert taff.score(taff.hit_tokens(words, h), 2) == jaff.score(
            jaff.hit_tokens(words, h), 2)
    assert (taff.CHUNK_TOKENS, taff.MAX_LEVELS, taff.SKETCH_WORDS,
            taff.W_QUEUE) == (jaff.CHUNK_TOKENS, jaff.MAX_LEVELS,
                              jaff.SKETCH_WORDS, jaff.W_QUEUE)
