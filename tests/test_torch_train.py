"""PyTorch port, train.py: loss, schedule, optimizer, Trainer steps,
checkpoints and the quiesce protocol against the JAX package, on the CPU,
from the same numpy inputs and converted weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan

torch.set_num_threads(1)


def _tiny():
    return jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()


def _params(seed=0):
    jcfg, tcfg = _tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(seed)))
    return tree, convert.params_from_numpy(tree, tcfg)


def _tokens(b=4, s=32, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_loss_fn_matches_jax():
    jcfg, tcfg = _tiny()
    tree, params = _params(seed=1)
    toks = _tokens(seed=1)
    want = float(jtrain.loss_fn(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(toks), jcfg))
    got = float(ttrain.loss_fn(params, torch.from_numpy(toks).long(), tcfg))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("fields", [
    dict(),
    dict(warmup_steps=5),
    dict(decay_steps=8, min_lr_ratio=0.2),
    dict(warmup_steps=3, decay_steps=10),
])
def test_schedule_matches_optax_at_its_boundaries(fields):
    jtc, ttc = jtrain.TrainConfig(**fields), ttrain.TrainConfig(**fields)
    js, ts = jtrain.make_schedule(jtc), ttrain.make_schedule(ttc)
    if not callable(js):
        assert not callable(ts) and ts == js
        return
    w, d = ttc.warmup_steps, ttc.decay_steps
    for n in sorted({0, 1, w - 1, w, w + 1, w + d - 1, w + d, w + d + 7}):
        if n >= 0:
            assert ts(n) == pytest.approx(float(js(n)), rel=1e-6, abs=1e-12), n


@pytest.mark.parametrize("scale", [0.1, 50.0])
def test_adamw_matches_optax_chain(scale):
    """One tree, grads below (no clip) and far above the clip norm; the
    bias correction and the schedule over 3 updates."""
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 6), "n": (6,), "b": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tc = dict(warmup_steps=2, decay_steps=4, weight_decay=0.1)
    opt = jtrain.make_optimizer(jtrain.TrainConfig(**tc))
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tadam = ttrain.AdamW(ttrain.TrainConfig(**tc))
    ts = tadam.init(tp)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tadam.update([torch.from_numpy(g[k]) for k in tp], ts, list(tp.values()))
    assert ts["count"] == 3
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def test_adamw_moments_keep_the_param_dtype():
    p = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
         "n": torch.ones(4)}
    st = ttrain.AdamW(ttrain.TrainConfig()).init(p)
    assert st["mu"]["w"].dtype == torch.bfloat16
    assert st["nu"]["n"].dtype == torch.float32


@pytest.mark.parametrize("fields", [dict(), dict(warmup_steps=1,
                                                 decay_steps=3)])
def test_three_steps_match_jax_trainer(fields):
    """3 AdamW steps on tiny from identical params and tokens. Adam divides
    by sqrt(nu): where a grad is near zero its sign can flip between the two
    runtimes' summation orders and move that element by up to ~lr, so each
    element is bounded by 2 * lr per step, and almost all of them must agree
    to 1e-5."""
    jcfg, tcfg = _tiny()
    tree, params = _params(seed=3)
    jtr = jtrain.Trainer.create(jcfg, JMeshPlan(),
                                tc=jtrain.TrainConfig(**fields),
                                devices=jax.devices()[:1])
    jstate = {"params": jax.tree.map(jnp.asarray, tree),
              "opt_state": jtr.optimizer.init(jax.tree.map(jnp.asarray, tree)),
              "step": jnp.zeros((), jnp.int32)}
    ttr = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(**fields),
                                device="cpu")
    tstate = ttr.state_from_params(params)
    for i in range(3):
        toks = _tokens(seed=10 + i)
        jstate, jm = jtr.step(jstate, jtr.shard_batch(jnp.asarray(toks)))
        tstate, tm = ttr.step(tstate, ttr.shard_batch(toks))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    assert tstate["step"] == 3 and tstate["opt_state"]["count"] == 3
    lr = ttr.tc.learning_rate
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jstate["params"]))
    tleaves = jax.tree.leaves(convert.params_to_numpy(tstate["params"]))
    diffs = np.concatenate([np.abs(t - j).ravel()
                            for t, j in zip(tleaves, jleaves)])
    assert diffs.max() <= 2 * lr * 3
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_accum_steps_equal_the_full_batch():
    _, tcfg = _tiny()
    toks = _tokens(b=4, seed=4)
    out = []
    for accum in (1, 2):
        _, params = _params(seed=4)
        tr = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(
            accum_steps=accum), device="cpu")
        state = tr.state_from_params(params)
        state, m = tr.step(state, tr.shard_batch(toks))
        out.append((m, state))
    (m1, s1), (m2, s2) = out
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    for a, b in zip(ttrain.tree_leaves(s1["params"]),
                    ttrain.tree_leaves(s2["params"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    tr = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(accum_steps=3),
                               device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        tr.step(tr.init(), tr.shard_batch(toks))


def test_checkpoint_round_trip_and_purge(tmp_path):
    _, tcfg = _tiny()
    tr = ttrain.Trainer.create(tcfg, device="cpu")
    state = tr.init(seed=5)
    state, _ = tr.step(state, tr.shard_batch(_tokens(seed=5)))
    path = str(tmp_path / "ckpt")
    ttrain.save_checkpoint(path, state, 2)
    ttrain.save_checkpoint(path, state, 4)
    # debris of a save killed midway
    os.makedirs(os.path.join(path, "6.tmp-999"))
    with open(os.path.join(path, "6.tmp-999", "state.pt"), "wb") as f:
        f.write(b"torn")
    restored, step = ttrain.restore_checkpoint(path, tr.abstract_state())
    assert step == 4 and sorted(os.listdir(path)) == ["2", "4"]
    assert restored["step"] == state["step"]
    assert restored["opt_state"]["count"] == 1
    for a, b in zip(ttrain.tree_leaves(state["params"]),
                    ttrain.tree_leaves(restored["params"])):
        assert torch.equal(a, b) and b.requires_grad
    for a, b in zip(ttrain.tree_leaves(state["opt_state"]["nu"]),
                    ttrain.tree_leaves(restored["opt_state"]["nu"])):
        assert torch.equal(a, b)
    # the restored state trains on
    tr.step(restored, tr.shard_batch(_tokens(seed=6)))
    assert ttrain.purge_incomplete_checkpoints(path) == 0
    assert ttrain.purge_incomplete_checkpoints(str(tmp_path / "none")) == 0


def test_restore_refuses_missing_or_mismatched(tmp_path):
    _, tcfg = _tiny()
    with pytest.raises(FileNotFoundError):
        ttrain.restore_checkpoint(str(tmp_path / "empty"))
    tr = ttrain.Trainer.create(tcfg, device="cpu")
    ttrain.save_checkpoint(str(tmp_path / "c"), tr.init(), 1)
    other = ttrain.Trainer.create(tllama.LlamaConfig(
        vocab_size=256, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=64, dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        ttrain.restore_checkpoint(str(tmp_path / "c"), other.abstract_state())


def test_quiesce_marker_and_ack_bytes_match_jax(tmp_path, monkeypatch):
    for name, mod in (("jax", jtrain), ("torch", ttrain)):
        root = tmp_path / name
        root.mkdir()
        monkeypatch.setenv("CONTAINER_ROOT", str(root))
        mod.write_quiesce_marker(str(root / "ckpt"), 17)
        mod.write_quiesce_ack(17)
    for rel in ("ckpt/QUIESCED", ".quiesced"):
        assert ((tmp_path / "torch" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes())
    assert (tmp_path / "torch" / "ckpt" / "QUIESCED").read_bytes() == b"17\n"
    assert json.loads((tmp_path / "torch" / ".quiesced").read_text()) == {
        "step": 17}
    ckpt = str(tmp_path / "torch" / "ckpt")
    assert ttrain.read_quiesce_marker(ckpt) == 17
    ttrain.clear_quiesce_marker(ckpt)
    ttrain.clear_quiesce_marker(ckpt)            # idempotent
    assert ttrain.read_quiesce_marker(ckpt) is None
    assert ttrain.QUIESCE_MARKER == jtrain.QUIESCE_MARKER


def test_trainer_refuses_no_card_and_multi_device():
    _, tcfg = _tiny()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.Trainer.create(tcfg)
    # every axis is ported: a plan over more than one rank without its
    # groups is refused for that
    with pytest.raises(ValueError, match="needs the groups of its 4 ranks"):
        ttrain.Trainer.create(tcfg, MeshPlan(tp=2, pp=2), device="cpu")
    with pytest.raises(ValueError, match="needs the groups of its 2 ranks"):
        ttrain.Trainer.create(tcfg, MeshPlan(tp=2), device="cpu")
    # and the pipelined loss needs a batch its microbatches divide
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        ttrain.loss_fn({"layers": {"wq": torch.zeros(2, 1)}},
                       torch.zeros(1, 2, dtype=torch.long), tcfg,
                       n_microbatches=2,
                       groups=ttrain.MeshGroups(MeshPlan(pp=2), 0))
