"""PyTorch port, the lse consumers of ops/attention.py (merge_attention_partials,
_pair_lse_banded, blockwise_attention) against the JAX package's, on the CPU,
from the same numpy inputs made with a seed: outputs within 2e-5 and
gradients within 1e-4 (f32), every gradient finite.

The JAX blockwise_attention runs its Pallas kernels in interpret mode
(seconds a call), so it is the reference on a few cases and the JAX
reference_attention on the rest; the port's blockwise runs the kernels'
plain versions inside flash_attention_lse on CPU tensors."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu_torch.ops import attention as tatt

# importlib: the JAX ops package re-exports an `attention` function that
# shadows the submodule attribute
jatt = importlib.import_module("gpu_docker_api_tpu.ops.attention")

torch.set_num_threads(1)

OUT_TOL = 2e-5
GRAD_TOL = 1e-4


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


def _jax_vjp(fn, args, cot):
    """(fn(*args), grads of <fn(*args), cot>) in JAX, as numpy."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_vjp(fn, args, cot):
    ts = _torch(*args)
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    for g in grads:
        assert bool(torch.isfinite(g).all())
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want):
    (out, grads), (jout, jgrads) = got, want
    np.testing.assert_allclose(out, jout, atol=OUT_TOL, rtol=OUT_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_TOL, rtol=GRAD_TOL)


# ---- merge_attention_partials ---------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_merge_attention_partials_matches_jax(n):
    """n partials, some rows -inf in some partials (a set the row cannot
    see), one row -inf in all of them (output 0, zero gradients)."""
    b, s, h, d = 2, 8, 3, 4
    outs = _arrays(n, *[(b, s, h, d)] * n)
    lses = _arrays(100 + n, *[(b, h, s)] * n)
    for i, lse in enumerate(lses):
        lse[:, :, i] = -np.inf               # row i sees nothing in set i
        lse[0, 1, s - 1] = -np.inf           # this row sees nothing at all
    cot = _arrays(7, (b, s, h, d))[0]

    def jfn(*xs):
        return jatt.merge_attention_partials(list(xs[:n]), list(xs[n:]))

    def tfn(*xs):
        return tatt.merge_attention_partials(list(xs[:n]), list(xs[n:]))

    got = _torch_vjp(tfn, outs + lses, cot)
    _close(got, _jax_vjp(jfn, outs + lses, cot))
    assert np.all(got[0][0, s - 1, 1] == 0)


# ---- _pair_lse_banded -----------------------------------------------------------

@pytest.mark.parametrize("offset, window", [
    (0, 5),       # the diagonal chunk
    (8, 20),      # behind, wholly inside the window
    (16, 20),     # the boundary chunk: partly masked, the first rows see none
    (32, 20),     # wholly outside: every row -inf
])
def test_pair_lse_banded_matches_jax(offset, window):
    b, s, h, hkv, d = 1, 16, 4, 2, 8
    q, k, v = _arrays(offset, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    cot_o, cot_l = _arrays(offset + 1, (b, s, h, d), (b, h, s))

    def jfn(q, k, v):
        o, lse = jatt._pair_lse_banded(q, k, v, offset, window)
        return o, jnp.where(jnp.isfinite(lse), lse, 0.0)

    def tfn(q, k, v):
        o, lse = tatt._pair_lse_banded(q, k, v, offset, window)
        return o, torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))

    (jo, jl), jvjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = jvjp((jnp.asarray(cot_o), jnp.asarray(cot_l)))
    ts = _torch(q, k, v)
    o, lse = tfn(*ts)
    grads = torch.autograd.grad((o, lse), ts, (torch.from_numpy(cot_o),
                                               torch.from_numpy(cot_l)))
    np.testing.assert_allclose(o.detach().numpy(), jo, atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), jl, atol=OUT_TOL,
                               rtol=OUT_TOL)
    for g, jg in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    # the raw lse: -inf exactly where JAX has it
    _, jraw = jatt._pair_lse_banded(*map(jnp.asarray, (q, k, v)), offset,
                                    window)
    _, raw = tatt._pair_lse_banded(*map(torch.from_numpy, (q, k, v)), offset,
                                   window)
    np.testing.assert_array_equal(np.isinf(raw.numpy()),
                                  np.isinf(np.asarray(jraw)))


# ---- blockwise_attention --------------------------------------------------------

def _blockwise_case(b, s, h, hkv, d, causal, window, chunk, reference, seed):
    q, k, v, cot = _arrays(seed, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                           (b, s, h, d))

    def tfn(q, k, v):
        return tatt.blockwise_attention(q, k, v, causal=causal,
                                        window=window, chunk=chunk)

    if reference == "blockwise":       # the JAX function, Pallas interpreted
        def jfn(q, k, v):
            return jatt.blockwise_attention(q, k, v, causal=causal,
                                            window=window, chunk=chunk,
                                            interpret=True)
    else:
        def jfn(q, k, v):
            return jatt.reference_attention(q, k, v, causal=causal,
                                            window=window)
    _close(_torch_vjp(tfn, (q, k, v), cot), _jax_vjp(jfn, (q, k, v), cot))


@pytest.mark.parametrize("causal, window, hkv", [
    (True, 0, 2),       # the stacked plan
    (True, 10, 2),      # the loop plan, window below chunk
    (False, 0, 1),      # non-causal, GQA group 2
])
def test_blockwise_matches_the_jax_blockwise(causal, window, hkv):
    _blockwise_case(1, 64, 2, hkv, 16, causal, window, 16, "blockwise",
                    seed=3)


@pytest.mark.parametrize("causal, window, hkv", [
    (True, 0, 4),        # stacked plan, 8 chunks: 28 past pairs in 16/8/4
    (True, 0, 1),        # the same, GQA group 4
    (True, 5, 2),        # window below chunk: diagonal and boundary only
    (True, 16, 2),       # window equal to chunk
    (True, 40, 2),       # window above chunk: full pairs and a boundary
    (True, 128, 2),      # window covering the sequence
    (False, 0, 2),       # non-causal loop plan
])
def test_blockwise_matches_the_reference(causal, window, hkv):
    _blockwise_case(2, 128, 4, hkv, 8, causal, window, 16, "reference",
                    seed=window + hkv)


@pytest.mark.parametrize("window", [0, 24])
def test_blockwise_at_or_under_one_chunk_is_one_kernel_call(window):
    """s <= chunk takes one flash_attention call; a seq that the chunk
    does not divide raises."""
    _blockwise_case(1, 32, 2, 2, 16, True, window, 32, "reference", seed=9)
    q = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tatt.blockwise_attention(q, q, q, chunk=16)


def test_stack_groups_are_the_jax_plans_groups():
    """The past pairs' launch groups: powers of two of FLASH_PAIR_STACK,
    largest first (JAX :862-869)."""
    assert tatt.FLASH_PAIR_STACK == jatt.FLASH_PAIR_STACK == 32
    assert tatt.FLASH_CHUNK_SEQ == jatt.FLASH_CHUNK_SEQ == 2048
    assert tatt._stack_groups(28) == [16, 8, 4]       # S=16384, n=8
    assert tatt._stack_groups(6) == [4, 2]            # n=4
    assert tatt._stack_groups(1) == [1]
    assert tatt._stack_groups(120) == [32, 32, 32, 16, 8]
    assert sum(tatt._stack_groups(496)) == 496

