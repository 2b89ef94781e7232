"""PyTorch port, models/: the Llama trunk against the JAX package on the
same weights (converted from the JAX init) and the same tokens, on the CPU.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu.models import NAMED_CONFIGS as J_NAMED
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch.models import NAMED_CONFIGS as T_NAMED
from gpu_docker_api_tpu_torch.models import family_for, llama as tllama
from gpu_docker_api_tpu_torch.models import named_config
from gpu_docker_api_tpu_torch.train import tree_leaves

torch.set_num_threads(1)

# f32 tiny trunk, same math in a different summation order
LOGIT_TOL = 1e-4


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.key(seed)))


def _tokens(cfg, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _tiny_bf16():
    return (dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.bfloat16),
            dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bit_exact(dtype):
    jcfg, tcfg = ((jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny())
                  if dtype == "float32" else _tiny_bf16())
    tree = _jax_params(jcfg)
    params = convert.params_from_numpy(tree, tcfg)
    assert params["layers"]["wq"].dtype == tcfg.dtype
    assert params["layers"]["attn_norm"].dtype == torch.float32
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_converter_refuses_a_mismatched_tree():
    tree = _jax_params(jllama.LlamaConfig.tiny())
    tcfg = tllama.LlamaConfig.tiny()
    bad = dict(tree, lm_head=tree["lm_head"][:, :8])
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_numpy(bad, tcfg)
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy({"embed": tree["embed"]}, tcfg)
    with pytest.raises(ValueError, match="dtype"):
        convert.params_from_numpy(tree, dataclasses.replace(
            tcfg, dtype=torch.bfloat16))


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_tiny_logits_match_jax(impl):
    """Converted weights, same tokens: the port's logits (reference
    attention, or the flash path's plain versions) against
    llama_forward(impl="xla")."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = _jax_params(jcfg, seed=1)
    toks = _tokens(jcfg)
    want = np.asarray(jllama.llama_forward(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(toks), jcfg,
                                           impl="xla"))
    got = tllama.llama_forward(convert.params_from_numpy(tree, tcfg),
                               torch.from_numpy(toks).long(), tcfg, impl=impl)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_equal_grads(remat):
    tcfg = tllama.LlamaConfig.tiny()
    params = convert.params_from_numpy(_jax_params(jllama.LlamaConfig.tiny()),
                                       tcfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(_tokens(tcfg, seed=2)).long()

    def grads(policy):
        out = tllama.llama_forward(params, toks, tcfg, remat=policy)
        return torch.autograd.grad(out.square().mean(), tree_leaves(params))

    for a, b in zip(grads("none"), grads(remat)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    """Both table forms: shared positions [S, Dh/2] and per-row [B, S, Dh/2]
    (the continuous-batching slot cache's)."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 4, tcfg.head_dim)).astype(np.float32)
    pos = (rng.integers(0, 100, (2, 6)) if per_row
           else np.arange(6)).astype(np.int32)
    jpos = jnp.asarray(pos)
    if per_row:
        jcos, jsin = jax.vmap(lambda p: jllama.rope_frequencies(jcfg, p))(jpos)
    else:
        jcos, jsin = jllama.rope_frequencies(jcfg, jpos)
    want = np.asarray(jllama.apply_rope(jnp.asarray(x), jcos, jsin))
    cos, sin = tllama.rope_frequencies(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    got = tllama.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_named_configs_match_jax():
    assert set(T_NAMED["llama"]) == set(J_NAMED["llama"])
    for name, make in T_NAMED["llama"].items():
        t, j = make(), J_NAMED["llama"][name]()
        for field in dataclasses.fields(j):
            tv, jv = getattr(t, field.name), getattr(j, field.name)
            if field.name == "dtype":
                assert str(tv).split(".")[-1] == jnp.dtype(jv).name, name
            else:
                assert tv == jv, (name, field.name)
        assert t.head_dim == j.head_dim


def test_param_shapes_match_jax_init_at_1b():
    jcfg = jllama.LlamaConfig.llama_1b()
    shapes = jax.eval_shape(lambda k: jllama.init_params(jcfg, k),
                            jax.random.key(0))
    tshapes = tllama.param_shapes(tllama.LlamaConfig.llama_1b())
    flat_t = jax.tree.leaves(tshapes, is_leaf=lambda x: isinstance(x, tuple))
    for j, (shape, dtype) in zip(jax.tree.leaves(shapes), flat_t):
        assert tuple(j.shape) == shape
        assert jnp.dtype(j.dtype).name == str(dtype).split(".")[-1]
    n = sum(math.prod(s) for s, _ in flat_t)
    assert 1.0e9 < n < 1.1e9             # ~1.07B params


def test_init_params_layout_and_scale():
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    spec = tllama.param_shapes(cfg)
    assert params["layers"]["wq"].shape == spec["layers"]["wq"][0]
    assert (params["final_norm"] == 1).all()
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(params["lm_head"], again["lm_head"])
    assert sum(p.numel() for p in tree_leaves(params)) == sum(
        math.prod(s) for s, _ in jax.tree.leaves(
            spec, is_leaf=lambda x: isinstance(x, tuple)))


def test_family_registry():
    cfg = named_config("llama", "1b")
    assert family_for(cfg).name == "llama"
    moe = named_config("moe", "tiny")
    assert family_for(moe).name == "moe" and moe.n_experts == 4
    with pytest.raises(KeyError, match="choices"):
        named_config("llama", "nosuch")


def test_pp_is_ported_for_either_family():
    """pp was the last axis refused: a pp plan builds its trainer for
    either family, and the pipelined loss without a pp group is JAX's pp=1
    fast path, the whole batch through every layer in order (so MoE routes
    it as one pool: the loss of the plain forward)."""
    from gpu_docker_api_tpu_torch.models import moe as tmoe
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer, loss_fn
    cfg = tmoe.MoEConfig.tiny()
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(
            loss_fn(params, tokens, cfg, n_microbatches=2),
            loss_fn(params, tokens, cfg), rtol=1e-6, atol=1e-6)
    for c in (cfg, tllama.LlamaConfig.tiny()):
        for plan in (MeshPlan(pp=2, ep=2), MeshPlan(dp=2, fsdp=2, pp=2),
                     MeshPlan(pp=2, tp=2, sp=2)):
            assert Trainer.create(c, plan, device="cpu",
                                  groups=MeshGroups(plan, 0)).pipelined
