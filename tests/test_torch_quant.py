"""PyTorch port, ops/quant.py: int8 weights against the JAX package on the
same weights (converted from the JAX init) and the same inputs, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import infer as jinfer
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.ops import quant as jquant
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as tinfer
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (3, 16, 8)])
def test_quantize_matches_jax(shape):
    """q may differ by one step where x / s sits at a rounding tie (the
    division's last bit); s agrees to f32 precision."""
    w = _normal(0, *shape)
    jq = jquant.quantize(jnp.asarray(w))
    tq = tquant.quantize(torch.from_numpy(w))
    assert tq.q.dtype == torch.int8 and tq.s.dtype == torch.float32
    assert tq.s.shape == tuple(jq.s.shape) and tq.shape == tuple(jq.shape)
    np.testing.assert_allclose(tq.s.numpy(), np.asarray(jq.s), rtol=1e-6)
    diff = np.abs(tq.q.numpy().astype(int) - np.asarray(jq.q).astype(int))
    assert diff.max() <= 1
    # symmetric per-channel: |error| <= scale / 2 per element
    err = np.abs(tquant.dequantize(tq, torch.float32).numpy() - w)
    assert (err <= tq.s.numpy()[..., None, :] * 0.5 + 1e-6).all()


def test_quantize_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tquant.quantize(torch.ones(4, 4), "int4")


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("rows", [(1,), (4,), (2, 3)])
def test_qmatmul_matches_jax(mode, rows):
    x, w = _normal(1, *rows, 64), _normal(2, 64, 16)
    jq = jquant.quantize(jnp.asarray(w), mode)
    # the same int8 weights on both sides, so the products compare exactly
    tq = tquant.QTensor(torch.tensor(np.asarray(jq.q)),
                        torch.tensor(np.asarray(jq.s)), mode)
    want = np.asarray(jquant.qmatmul(jnp.asarray(x), jq))
    got = tquant.qmatmul(torch.from_numpy(x), tq)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_qmatmul_dense_passthrough():
    x, w = torch.from_numpy(_normal(3, 4, 16)), torch.from_numpy(_normal(4, 16, 8))
    torch.testing.assert_close(tquant.qmatmul(x, w), x @ w)


def test_qtensor_unbinds_its_layer_axis():
    qt = tquant.quantize(torch.from_numpy(_normal(5, 3, 16, 8)), "w8a8")
    parts = qt.unbind(0)
    assert len(parts) == 3
    for i, p in enumerate(parts):
        assert p.mode == "w8a8" and p.shape == (16, 8) and p.s.shape == (8,)
        assert torch.equal(p.q, qt.q[i]) and torch.equal(p.s, qt.s[i])


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_params_matches_jax(tiny, mode):
    jcfg, tcfg, tree = tiny
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), mode)
    tq = tquant.quantize_params(convert.params_from_numpy(tree, tcfg), mode)
    assert tquant.is_quantized(tq) and jquant.is_quantized(jq)
    assert set(tq["layers"]) == set(jq["layers"]) and set(tq) == set(jq)
    for name in tquant.QUANT_KEYS:
        assert isinstance(tq["layers"][name], tquant.QTensor)
        assert tq["layers"][name].mode == mode
    for name in ("attn_norm", "mlp_norm"):
        assert isinstance(tq["layers"][name], torch.Tensor)
    assert isinstance(tq["embed"], torch.Tensor)
    # on the carried weights the int8 values and scales are the JAX ones
    pairs = [(tq["layers"][k], jq["layers"][k]) for k in tquant.QUANT_KEYS]
    for t, j in pairs + [(tq["lm_head"], jq["lm_head"])]:
        np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    with pytest.raises(ValueError):
        tquant.quantize_params(convert.params_from_numpy(tree, tcfg), "int4")


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_prefill_and_generate_match_jax(tiny, mode):
    """Each package quantizes the carried weights with its own
    quantize_params: the port's prefill logits and greedy tokens equal the
    JAX package's."""
    jcfg, tcfg, tree = tiny
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), mode)
    tq = tquant.quantize_params(convert.params_from_numpy(tree, tcfg), mode)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jinfer.prefill(jq, jnp.asarray(prompt),
                             jinfer.init_cache(jcfg, 2, 16), jcfg)
    got, _ = tinfer.prefill(tq, torch.from_numpy(prompt).long(),
                            tinfer.init_cache(tcfg, 2, 16, device="cpu"), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jinfer.generate(jq, jnp.asarray(prompt), jcfg, 8))
    got = tinfer.generate(tq, torch.from_numpy(prompt).long(), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), want)
