"""PyTorch port, the MoE family (models/moe.py) for training and serving:
the config, routing, both dispatch paths, moe_block / moe_forward, the
loss and a Trainer step, the int8 expert banks (qeinsum, quantize_params,
quantize_params_streaming), MoE decode and generate, the dense and paged
batchers, and the train_llama / serve entry points, against the JAX
package on the same numpy inputs and converted weights, on the CPU.

Tolerances: routing decisions, capacity positions, int8 bits and greedy
tokens are exact. f32 values agree to 1e-5 (summation order); bf16 logits
to 0.05 absolute and the bf16 router loss to 2e-3 relative (bf16 rounding
of the residual stream through two layers)."""

import dataclasses
import http.client
import json
import os
import sys
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import infer as ji
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.ops import quant as jquant
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu.workloads import serve as jserve
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import infer as ti
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.models import named_config, param_shapes
from gpu_docker_api_tpu_torch.ops import quant as tquant
from gpu_docker_api_tpu_torch.workloads import serve as tserve
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402  (scheduled_streams)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.05
BF16_REL = 2e-3    # the bf16 router loss (read 6e-4)


def _jax_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, jmoe.init_params(cfg, jax.random.key(seed)))


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, jax params, port params)."""
    jcfg, tcfg = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    tree = _jax_tree(jcfg)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg))


def _tokens(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _long(a):
    return torch.from_numpy(np.array(a)).long()


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---- the config and the parameters ---------------------------------------------

NAMED = ("tiny", "moe_mini", "moe_1b", "mixtral_8x7b")


@pytest.mark.parametrize("name", NAMED)
def test_named_configs_and_capacity_equal_jax(name):
    j, t = getattr(jmoe.MoEConfig, name)(), getattr(tmoe.MoEConfig, name)()
    for f in dataclasses.fields(j):
        if f.name == "dtype":
            assert str(getattr(t, "dtype")).split(".")[-1] == \
                jnp.dtype(j.dtype).name
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.head_dim == j.head_dim
    for n in (1, 2, 3, 7, 8, 64, 257, 4096, 16384):
        assert t.capacity(n) == j.capacity(n), n
    lj, lt = j.as_llama(), t.as_llama()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq_len", "rope_theta", "norm_eps"):
        assert getattr(lt, f) == getattr(lj, f), f
    assert lt.sliding_window == 0


@pytest.mark.parametrize("name", NAMED)
def test_param_shapes_equal_the_jax_init(name):
    """The family's shape tree is the JAX init's (shapes and dtypes, the
    router in f32), for every named config, without allocating."""
    j, t = getattr(jmoe.MoEConfig, name)(), getattr(tmoe.MoEConfig, name)()
    want = jax.eval_shape(lambda: jmoe.init_params(j, jax.random.key(0)))
    got = param_shapes(t)

    def walk(g, w, path=""):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}{k}.")
                continue
            shape, dtype = g[k]
            assert shape == tuple(w[k].shape), path + k
            assert str(dtype).split(".")[-1] == w[k].dtype.name, path + k
    walk(got, want)
    assert got["layers"]["router"][1] == torch.float32


def test_init_params_draws_the_family_tree():
    cfg = tmoe.MoEConfig.tiny()
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = param_shapes(cfg)
    for name, (shape, dtype) in shapes["layers"].items():
        leaf = params["layers"][name]
        assert tuple(leaf.shape) == shape and leaf.dtype == dtype, name
    assert (params["layers"]["mlp_norm"] == 1).all()
    assert abs(float(params["layers"]["we1"].std()) - 0.02) < 0.002
    placed = tmoe.init_params(cfg, torch.Generator().manual_seed(0),
                              place=lambda t: t.clone())
    for a, b in zip(ttrain.tree_leaves(params), ttrain.tree_leaves(placed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bit_exact_on_the_moe_tree(dtype):
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tmoe.MoEConfig.tiny(),
                               dtype=getattr(torch, dtype))
    tree = _jax_tree(jcfg, seed=3)
    params = convert.params_from_numpy(tree, tcfg)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["we2"].dtype == getattr(torch, dtype)
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(tree, tcfg.as_llama())


# ---- routing --------------------------------------------------------------------

@pytest.mark.parametrize("t, k, e, seed", [(16, 2, 4, 0), (96, 2, 8, 1),
                                           (33, 3, 5, 2), (7, 1, 4, 3)])
def test_capacity_positions_exact_against_jax(t, k, e, seed):
    """One rank's global_positions (no routing group: the call's tokens
    are the whole array), in one row block or in as many as t's smallest
    factor above 1, are JAX's capacity_positions."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])  # [T, K]
    onehot = np.eye(e, dtype=np.int32)[idx]                      # [T, K, E]
    want = np.asarray(jmoe.capacity_positions(jnp.asarray(onehot)))
    rows = next(r for r in range(2, t + 1) if t % r == 0)
    for n in (1, rows):
        got, top1 = tmoe.global_positions(torch.from_numpy(onehot), n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(top1.numpy(), onehot[:, 0].sum(0))


def _jax_route(ht, router, cfg):
    logits = jnp.asarray(ht, jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    cap = cfg.capacity(ht.shape[0])
    onehot = jax.nn.one_hot(gate_idx, cfg.n_experts, dtype=jnp.int32)
    pos = jmoe.capacity_positions(onehot)
    return gate_vals, gate_idx, pos, pos < cap


@pytest.mark.parametrize("case", ["random", "exact ties"])
def test_routing_is_exact_against_jax(case):
    """gate_idx, gate_vals, positions and keep equal the JAX routing, with
    tokens crowding two experts so capacity drops choices. With exact ties
    (router column 2 a copy of column 0, so their probabilities are equal
    bit for bit) the lower index comes first, as jax.lax.top_k orders it:
    expert 2 is picked only second, after expert 0."""
    jcfg, tcfg = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    rng = np.random.default_rng(5)
    t = 64
    ht = (rng.standard_normal((t, tcfg.d_model))
          + 3.0 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    router = (0.1 * rng.standard_normal(
        (tcfg.d_model, tcfg.n_experts))).astype(np.float32)
    if case == "exact ties":
        router[:, 2] = router[:, 0]
    jv, ji_, jp, jk = (np.asarray(a) for a in _jax_route(
        jnp.asarray(ht), jnp.asarray(router), jcfg))
    (_, probs, tv, tidx, _, tpos, tkeep, cap) = tmoe._route(
        torch.from_numpy(ht), torch.from_numpy(router), tcfg)
    assert cap == jcfg.capacity(t)
    np.testing.assert_array_equal(tidx.numpy(), ji_)
    np.testing.assert_array_equal(tpos.numpy(), jp)
    np.testing.assert_array_equal(tkeep.numpy(), jk)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    assert not tkeep.all(), "capacity must drop choices here"
    if case == "exact ties":
        p, idx = probs.numpy(), tidx.numpy()
        assert np.array_equal(p[:, 0], p[:, 2])
        picked2 = (idx == 2).any(axis=1)
        assert picked2.any()
        assert (idx[picked2, 0] == 0).all() and (idx[picked2, 1] == 2).all()


def test_gather_and_einsum_dispatch_agree_under_drops(tiny):
    """The twin of tests/test_model.py::test_moe_gather_einsum_dispatch_agree:
    both dispatch paths under a capacity tight enough to drop, each
    against the JAX path of its name."""
    jcfg, tcfg, jp, tp = tiny
    jlayer = jax.tree.map(lambda p: p[0], jp["layers"])
    tlayer = {k: v[0] for k, v in tp["layers"].items()}
    t = 96
    ht = np.random.default_rng(1).standard_normal(
        (t, tcfg.d_model)).astype(np.float32)
    gate_vals, gate_idx, pos, _ = _jax_route(jnp.asarray(ht),
                                             jlayer["router"], jcfg)
    cap = max(2, jcfg.capacity(t) // 2)
    keep = pos < cap
    assert not bool(jnp.all(keep))

    def pin(arr, spec):
        return arr

    args_t = (torch.from_numpy(ht), tlayer, tcfg,
              _long(gate_idx), torch.from_numpy(np.asarray(gate_vals)),
              torch.from_numpy(np.asarray(keep)), _long(pos), cap)
    ein = tmoe._moe_experts_einsum(*args_t)
    gat = tmoe._moe_experts_gather(*args_t)
    np.testing.assert_allclose(ein.numpy(), gat.numpy(), **TOL)
    for name, fn in (("einsum", jmoe._moe_experts_einsum),
                     ("gather", jmoe._moe_experts_gather)):
        want = np.asarray(fn(jnp.asarray(ht), jlayer, jcfg, gate_idx,
                             gate_vals, keep, pos, cap, pin))
        got = ein if name == "einsum" else gat
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


# ---- the block and the forward ----------------------------------------------------

def _cfgs(dtype):
    return (dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=getattr(jnp, dtype)),
            dataclasses.replace(tmoe.MoEConfig.tiny(),
                                dtype=getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    tree = _jax_tree(jcfg, seed=2)
    params = convert.params_from_numpy(tree, tcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda p: jnp.asarray(p[1]), tree["layers"])
    jx, jaux, jz = jmoe.moe_block(jnp.asarray(x).astype(jcfg.dtype), jlayer,
                                  jcfg)
    tx, taux, tz = tmoe.moe_block(
        torch.from_numpy(x).to(tcfg.dtype),
        {k: v[1] for k, v in params["layers"].items()}, tcfg)
    assert tx.dtype == tcfg.dtype and taux.dtype == tz.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=1e-5, atol=atol)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(tz) == pytest.approx(float(jz), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_logits_and_router_loss_match_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    tree = _jax_tree(jcfg, seed=4)
    toks = _tokens(2, 32, seed=4)
    jl, jr = jmoe.moe_forward(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(toks), jcfg, impl="xla")
    tl, tr = tmoe.moe_forward(convert.params_from_numpy(tree, tcfg),
                              _long(toks), tcfg, impl="xla")
    assert tl.dtype == torch.float32 and tl.shape == (2, 32, 256)
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=atol)
    rel = 1e-4 if dtype == "float32" else BF16_REL
    assert float(tr) == pytest.approx(float(jr), rel=rel)


def test_moe_forward_auto_on_the_cpu_takes_the_plain_attention(tiny):
    """impl="auto" on a CPU tensor is the kernels' plain version, so it
    agrees with impl="xla" (on the card it is the flash kernels)."""
    _, tcfg, _, tp = tiny
    toks = _long(_tokens(1, 16, seed=6))
    a, ra = tmoe.moe_forward(tp, toks, tcfg, impl="auto")
    b, rb = tmoe.moe_forward(tp, toks, tcfg, impl="xla")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert float(ra) == pytest.approx(float(rb), rel=1e-5)


def test_remat_policies_give_the_same_loss_and_grads(tiny):
    _, tcfg, _, _ = tiny
    toks = _long(_tokens(2, 32, seed=7))
    out = {}
    for remat in ("none", "full", "dots"):
        params = convert.params_from_numpy(_jax_tree(jmoe.MoEConfig.tiny(), 7),
                                           tcfg)
        leaves = ttrain.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = ttrain.loss_fn(params, toks, tcfg, remat=remat != "none",
                              remat_policy=remat if remat != "none"
                              else "dots")
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_and_grads_match_jax(tiny):
    jcfg, tcfg, jp, _ = tiny
    tree = _jax_tree(jcfg, seed=8)
    toks = _tokens(2, 32, seed=8)
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jcfg)
    params = convert.params_from_numpy(tree, tcfg)
    leaves = ttrain.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.loss_fn(params, _long(toks), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    flat_t = dict(zip(_paths(params), grads))
    flat_j = _named_jax(jgrads)
    assert set(flat_t) == set(flat_j)
    for name, g in flat_t.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(flat_j[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _paths(tree, prefix=""):
    """Leaf names of one of the port's trees, in tree_leaves' order."""
    out = []
    for k, v in tree.items():
        out += (_paths(v, f"{prefix}{k}.") if isinstance(v, dict)
                else [prefix + k])
    return out


def _named_jax(tree) -> dict:
    """{leaf name: numpy leaf} of a JAX tree."""
    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_trainer_steps_match_the_jax_trainer(tiny):
    """Two AdamW steps on tiny from the same params and tokens: losses and
    grad norms to 1e-4, the parameters as tests/test_torch_train.py holds
    the llama step (Adam's sign flips near zero grads: at most 2 lr a step
    anywhere, 1e-5 almost everywhere)."""
    jcfg, tcfg, _, _ = tiny
    tree = _jax_tree(jcfg, seed=9)
    jtr = jtrain.Trainer.create(jcfg, JMeshPlan(), devices=jax.devices()[:1])
    jstate = {"params": jax.tree.map(jnp.asarray, tree),
              "opt_state": jtr.optimizer.init(jax.tree.map(jnp.asarray, tree)),
              "step": jnp.zeros((), jnp.int32)}
    ttr = ttrain.Trainer.create(tcfg, device="cpu")
    tstate = ttr.state_from_params(convert.params_from_numpy(tree, tcfg))
    for i in range(2):
        toks = _tokens(4, 32, seed=20 + i)
        jstate, jm = jtr.step(jstate, jtr.shard_batch(jnp.asarray(toks)))
        tstate, tm = ttr.step(tstate, ttr.shard_batch(toks))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    lr = ttr.tc.learning_rate
    want = _named_jax(jstate["params"])
    got = convert.params_to_numpy(tstate["params"])
    diffs = np.concatenate([
        np.abs(got_leaf - want[name]).ravel()
        for name, got_leaf in zip(_paths(got), ttrain.tree_leaves(got))])
    assert diffs.max() <= 2 * lr * 2
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_moe_checkpoint_restores_against_the_family_template(tmp_path):
    cfg = tmoe.MoEConfig.tiny()
    tr = ttrain.Trainer.create(cfg, device="cpu")
    state = tr.init(seed=1)
    ttrain.save_checkpoint(str(tmp_path), state, 3)
    restored, step = ttrain.restore_checkpoint(str(tmp_path),
                                               tr.abstract_state())
    assert step == 3
    for a, b in zip(ttrain.tree_leaves(state["params"]),
                    ttrain.tree_leaves(restored["params"])):
        assert torch.equal(a, b)
    llama = ttrain.Trainer.create(cfg.as_llama(), device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        ttrain.restore_checkpoint(str(tmp_path), llama.abstract_state())


# ---- int8 expert banks --------------------------------------------------------------

def test_qeinsum_matches_jax_and_refuses_what_it_refuses():
    """The twin of tests/test_quant.py::test_qeinsum_rejects_unsupported_
    scale_layouts: the supported layout against JAX's qeinsum, each
    refused layout with its message, and a w8a8 bank refused."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 8, 4)).astype(np.float32)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jb, tb = jquant.quantize(jnp.asarray(w), "w8"), tquant.quantize(
        torch.from_numpy(w), "w8")
    want = np.asarray(jquant.qeinsum("ecd,edf->ecf", jnp.asarray(a), jb))
    got = tquant.qeinsum("ecd,edf->ecf", torch.from_numpy(a), tb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = tquant.qeinsum("ecd,edf->ecf", torch.from_numpy(a),
                           torch.from_numpy(w))
    np.testing.assert_allclose(dense.numpy(), np.einsum("ecd,edf->ecf", a, w),
                               **TOL)
    w4 = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    cases = [("lecd,ledf->lecf", np.zeros((3, 2, 3, 8), np.float32), w4, "w8"),
             ("ecd,edf->efc", a, w, "w8"), ("ecd,edf->cef", a, w, "w8"),
             ("ecd,edf->ecf", a, w, "w8a8")]
    for spec, x, bank, mode in cases:
        msgs = []
        for mod, arr in ((jquant, jnp.asarray), (tquant, torch.from_numpy)):
            with pytest.raises(ValueError) as e:
                mod.qeinsum(spec, arr(x), mod.quantize(arr(bank), mode))
            msgs.append(str(e.value).split(":")[0])
        assert msgs[0] == msgs[1], spec


def _quant_equal(got, want, path=""):
    for k in want:
        if isinstance(want[k], dict):
            _quant_equal(got[k], want[k], f"{path}{k}.")
        elif isinstance(want[k], jquant.QTensor):
            assert isinstance(got[k], tquant.QTensor), path + k
            assert got[k].mode == want[k].mode, path + k
            np.testing.assert_array_equal(got[k].q.numpy(),
                                          np.asarray(want[k].q))
            assert got[k].s.numpy().tobytes() == \
                np.asarray(want[k].s).tobytes(), path + k
        else:
            assert not isinstance(got[k], tquant.QTensor), path + k


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_params_gives_jax_bits_with_w8_banks(tiny, mode):
    jcfg, tcfg, jp, tp = tiny
    want = jquant.quantize_params(jp, mode)
    got = tquant.quantize_params(tp, mode)
    _quant_equal(got, want)
    for k in tquant.MOE_EXPERT_KEYS:
        assert got["layers"][k].mode == "w8"
    assert got["layers"]["wq"].mode == mode
    assert tquant.MOE_EXPERT_KEYS == jquant.MOE_EXPERT_KEYS
    assert got["layers"]["router"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_quantize_params_streaming_equals_quantize_params(family, mode):
    """Bit for bit, every leaf, from a host tree: the host-load path's
    quantization is the on-device one."""
    cfg = named_config(family, "tiny")
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = ttrain.Trainer.create(cfg, device="cpu").init(3)["params"]
    params = ttrain.tree_map(lambda t: t.detach(), params)
    want = tquant.quantize_params(params, mode)
    got = tquant.quantize_params_streaming(params, mode, device="cpu")
    assert tquant.is_quantized(got)

    def walk(g, w):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k])
            elif isinstance(w[k], tquant.QTensor):
                assert g[k].mode == w[k].mode
                assert torch.equal(g[k].q, w[k].q)
                assert torch.equal(g[k].s, w[k].s)
            else:
                assert torch.equal(g[k], w[k]) and not g[k].requires_grad
    walk(got, want)
    with pytest.raises(ValueError, match="mode"):
        tquant.quantize_params_streaming(params, "w4", device="cpu")


def test_quantize_divides_as_ieee_on_any_device():
    """The scale is amax / 127 as a true division (no reciprocal), the
    quotient JAX computes: checked on values where x * (1/127) and x / 127
    round apart."""
    x = torch.arange(1, 20001, dtype=torch.float32) * 1.37e-3
    recip = x * torch.tensor(1 / 127.0, dtype=torch.float32)
    true = x / torch.tensor(127.0)
    assert not torch.equal(recip, true)     # the two differ somewhere
    w = torch.stack([x, -x])                # [2, N]: amax over dim -2 = x
    np.testing.assert_array_equal(tquant.quantize(w).s.numpy(),
                                  np.asarray(jquant.quantize(
                                      jnp.asarray(w.numpy())).s))
    assert torch.equal(tquant.quantize(w).s, true)


# ---- decode ------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["", "w8", "w8a8"])
def test_prefill_decode_and_generate_match_jax(tiny, quantize):
    jcfg, tcfg, jp, tp = tiny
    if quantize:
        jp, tp = (jquant.quantize_params(jp, quantize),
                  tquant.quantize_params(tp, quantize))
    prompt = _tokens(2, 8, seed=11)
    jc = ji.init_cache(jcfg, 2, 16)
    tc = ti.init_cache(tcfg, 2, 16, device="cpu")
    jl, jc = ji.prefill(jp, jnp.asarray(prompt), jc, jcfg)
    tl, tc = ti.prefill(tp, _long(prompt), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jc = ji.decode_step(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = ti.decode_step(tp, _long(tok), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    want = np.asarray(ji.generate(jp, jnp.asarray(prompt), jcfg, 8))
    got = ti.generate(tp, _long(prompt), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv8_generate_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    prompt = _tokens(2, 8, seed=12)
    want = np.asarray(ji.generate(jp, jnp.asarray(prompt), jcfg, 6,
                                  kv_quant=True))
    got = ti.generate(tp, _long(prompt), tcfg, 6, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_without_drops_is_moe_forward_greedy():
    """JAX's own oracle (tests/test_infer.py::test_generate_moe_matches_
    oracle) on the port, and held to JAX too: with capacity_factor 8
    nothing drops, so one-token decode and the full forward route alike
    and generate() is moe_forward's greedy stream."""
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), capacity_factor=8.0)
    tcfg = dataclasses.replace(tmoe.MoEConfig.tiny(), capacity_factor=8.0)
    tree = _jax_tree(jcfg)
    tp = convert.params_from_numpy(tree, tcfg)
    prompt = _long(_tokens(2, 8, seed=13))
    seq, oracle = prompt, []
    for _ in range(5):
        logits, _ = tmoe.moe_forward(tp, seq, tcfg)
        nxt = logits[:, -1].argmax(dim=-1)
        oracle.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    got = ti.generate(tp, prompt, tcfg, 5)
    assert torch.equal(got, torch.stack(oracle, dim=1))
    want = np.asarray(ji.generate(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(prompt.numpy(), jnp.int32),
                                  jcfg, 5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_generate_with_a_moe_draft_is_greedy(tiny):
    _, tcfg, _, tp = tiny
    draft = convert.params_from_numpy(_jax_tree(jmoe.MoEConfig.tiny(), 42),
                                      tcfg)
    prompt = _long(_tokens(1, 8, seed=14))
    got, stats = ti.speculative_generate(tp, draft, prompt, tcfg, tcfg, 9,
                                         gamma=3)
    assert torch.equal(got, ti.generate(tp, prompt, tcfg, 9))
    assert stats["rounds"] >= 1


# ---- the batchers, under one schedule -------------------------------------------------

BATCH_CASES = {
    "dense": dict(slots=3),
    "dense, chunked prefill, decode chunk": dict(slots=3, prefill_chunk=4,
                                                 decode_chunk=3),
    "paged": dict(slots=3, kv_block=4),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batcher_streams_equal_the_jax_batchers_under_one_schedule(tiny,
                                                                   case):
    """Five staggered requests into three slots at the real capacity (a
    decode step's three rows compete for two slots an expert): each port
    stream equals the JAX _Batcher's under the same schedule."""
    jcfg, tcfg, jp, tp = tiny
    kw = dict(BATCH_CASES[case], max_len=48)
    prompts = [p.astype(np.int32) for p in (
        np.random.default_rng(40).integers(0, 256, n) for n in
        (5, 9, 6, 12, 7))]
    at = (0, 1, 3, 6, 8)
    jb = jserve._Batcher(jcfg, jp, **kw)
    fns = (jb._fn_decode(), jb._fn_decode_pick(), jb._fn_decode_multi())
    try:
        want = cs.scheduled_streams(jb, lambda: jb._tick(*fns),
                                    [jnp.asarray(p) for p in prompts], at, 7)
    finally:
        jb.close()
    tb = tserve._Batcher(tcfg, tp, **kw)

    def tick():
        with torch.no_grad():
            tb._tick()
    try:
        got = cs.scheduled_streams(tb, tick, [_long(p) for p in prompts],
                                   at, 7)
    finally:
        tb.close()
    assert got == want


# ---- the entry points ------------------------------------------------------------------

def _metrics(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_llama_family_moe_trains_checkpoints_and_resumes(tmp_path):
    base = ["--device", "cpu", "--family", "moe", "--config", "tiny",
            "--batch", "2", "--seq", "16", "--checkpoint-every", "2",
            "--ep", "1", "--workdir", str(tmp_path)]
    assert ttl.main(base + ["--steps", "4"]) == 0
    assert ttl.main(base + ["--steps", "6"]) == 0
    recs = _metrics(tmp_path / "metrics.jsonl")
    steps = [r["step"] for r in recs if "step" in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert [r["checkpoint"] for r in recs if "checkpoint" in r] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in recs if "step" in r)
    state, step = ttrain.restore_checkpoint(
        str(tmp_path / "checkpoints"),
        ttrain.Trainer.create(tmoe.MoEConfig.tiny(),
                              device="cpu").abstract_state())
    assert step == 6 and "we1" in state["params"]["layers"]


class _OneCall:
    """Stands in for ThreadingHTTPServer: serves the handler main built on
    a free local port for GET /healthz and one greedy POST /generate,
    recorded in CALLS, then returns."""
    CALLS = []

    def __init__(self, address, handler):
        self.server_address = address
        self.handler = handler

    def serve_forever(self):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            port = httpd.server_address[1]
            self.CALLS.append((_call(port, "GET", "/healthz", None),
                               _call(port, "POST", "/generate",
                                     {"tokens": [[5, 9, 2, 7]],
                                      "max_new": 6})))
        finally:
            httpd.shutdown()
            httpd.server_close()

    def server_close(self):
        pass


def _call(port, method, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


@pytest.fixture
def served(monkeypatch):
    """Runs serve.main with the one-call server; returns (healthz,
    generate, the _Server's params) of each run."""
    made = []

    class Recorded(tserve._Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "ThreadingHTTPServer", _OneCall)
    monkeypatch.setattr(tserve, "_Server", Recorded)

    def run(extra):
        _OneCall.CALLS.clear()
        assert tserve.main(["--device", "cpu", "--port", "1",
                            "--family", "moe", "--config", "tiny",
                            *extra]) == 0
        (health, gen), = _OneCall.CALLS
        return health, gen, made[-1].params
    return run


@pytest.mark.parametrize("extra", [[], ["--batch-slots", "2"],
                                   ["--batch-slots", "2", "--kv-block", "8"],
                                   ["--quantize", "w8a8"]])
def test_serve_family_moe_starts_and_answers(served, capsys, extra):
    health, gen, params = served(extra)
    assert health["code"] == 200
    assert health["data"]["model"] == "moe/tiny"
    assert gen["code"] == 200 and len(gen["data"]["tokens"][0]) == 6
    assert "serving moe/tiny" in capsys.readouterr().out
    want = ti.generate(params, torch.tensor([[5, 9, 2, 7]]),
                       tmoe.MoEConfig.tiny(), 6)
    assert gen["data"]["tokens"] == want.tolist()


@pytest.mark.parametrize("family, mode", [("moe", "w8"), ("moe", "w8a8"),
                                          ("llama", "w8")])
def test_host_load_serves_the_quantize_tree(served, capsys, family, mode):
    """serve --host-load --quantize M starts and answers, and the int8 tree
    it serves is the --quantize M tree bit for bit (the same draws, the
    same quantization), with the same answer."""
    runs = {}
    for extra in (["--quantize", mode], ["--host-load", "--quantize", mode]):
        if family == "llama":
            extra = extra + ["--family", "llama"]
        runs[extra[0]] = served(extra)
    assert "host-loaded + streamed int8" in capsys.readouterr().out
    (h1, g1, p1), (h2, g2, p2) = runs["--quantize"], runs["--host-load"]
    assert g1 == g2 and h1 == h2 and g2["code"] == 200
    leaves = list(zip(ttrain.tree_leaves(p1), ttrain.tree_leaves(p2)))
    assert len(leaves) == len(ttrain.tree_leaves(p2))
    for a, b in leaves:
        if isinstance(a, tquant.QTensor):
            assert a.mode == b.mode
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
        else:
            assert torch.equal(a, b)


def test_host_load_restores_a_checkpoint_onto_the_host(tmp_path, served):
    cfg = tmoe.MoEConfig.tiny()
    tr = ttrain.Trainer.create(cfg, device="cpu")
    ttrain.save_checkpoint(str(tmp_path), tr.init(seed=5), 2)
    _, g1, p1 = served(["--checkpoint", str(tmp_path), "--quantize", "w8"])
    _, g2, p2 = served(["--checkpoint", str(tmp_path), "--host-load",
                        "--quantize", "w8"])
    assert g1 == g2
    assert torch.equal(p1["layers"]["we2"].q, p2["layers"]["we2"].q)


def test_moe_server_answers_as_the_jax_server(tiny):
    """The single-flight _Server on MoE weights: the greedy /generate of
    two rows equals the JAX server's on the same weights."""
    jcfg, tcfg, jp, tp = tiny
    body = {"tokens": [[5, 9, 2, 7], [1, 3, 3, 8]], "max_new": 6}
    got = tserve._Server(tcfg, tp).generate(body["tokens"], 6, 0.0)
    want = jserve._Server(jcfg, jp).generate(body["tokens"], 6, 0.0)
    assert got == want
