"""PyTorch port, tensor parallelism on the CPU: the Trainer over gloo ranks
on `tiny` (f32) for 3 steps under tp=2 (the heads divided), tp=4 (the
head-gather fallback: tiny's 2 kv heads of 16 give each rank half a kv
head), dp=2 x tp=2, fsdp=2 x tp=2 and tp=2 x sp=2 (ring and Ulysses),
remat "none" and "dots", against the JAX Trainer on the same MeshPlan
over forced CPU devices (loss and grad norm within rel 1e-4) and against
the port's one-rank Trainer (rel 1e-5; the gathered params within 1e-5);
then `train_llama --device cpu` under TDAPI_MESH_PLAN {"tp": 2}:
checkpoints, a SIGUSR1 quiesce of the launcher with its ranks and a
gapless resume, and a resume across plans ({"tp": 2}, one rank, {"fsdp":
2}) equal to an uninterrupted one-rank run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import llama as tllama
from test_torch_fsdp_train import quiesce_and_resume, resume_across

torch.set_num_threads(1)

STEPS = 3
# name: (plan, sp_attn); the remat policies run under each
PLANS = {
    "tp2": ({"tp": 2}, "ring"),
    "tp4": ({"tp": 4}, "ring"),
    "dp2xtp2": ({"dp": 2, "tp": 2}, "ring"),
    "fsdp2xtp2": ({"fsdp": 2, "tp": 2}, "ring"),
    "tp2xsp2-ring": ({"tp": 2, "sp": 2}, "ring"),
    "tp2xsp2-ulysses": ({"tp": 2, "sp": 2}, "ulysses"),
}
REMATS = ("none", "dots")
RUNS = [(name, remat) for name in PLANS for remat in REMATS]


def _setup():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.key(5)))
    batches = [np.random.default_rng(40 + i).integers(0, 256, (4, 32))
               .astype(np.int32) for i in range(STEPS)]
    return jcfg, tcfg, tree, batches


def _jax_run(jcfg, tree, batches, plan, attn):
    plan = JMeshPlan(**plan)
    tr = jtrain.Trainer.create(dataclasses.replace(jcfg, sp_attn=attn), plan,
                               devices=jax.devices()[:plan.size])
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    got = []
    for toks in batches:
        state, m = tr.step(state, tr.shard_batch(jnp.asarray(toks)))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got


def _one_rank(tcfg, tree, batches):
    one = ttrain.Trainer.create(tcfg, device="cpu")
    state = one.state_from_params(convert.params_from_numpy(tree, tcfg))
    got = []
    for toks in batches:
        state, m = one.step(state, one.shard_batch(toks))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got, convert.params_to_numpy(state["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per plan the JAX trainer's numbers, the port's one-rank trainer's,
    and every run of the port over its ranks: the plans of 2 ranks in one
    group, those of 4 in another."""
    jcfg, tcfg, tree, batches = _setup()
    jax_runs = {name: _jax_run(jcfg, tree, batches, plan, attn)
                for name, (plan, attn) in PLANS.items()}
    one_rank = _one_rank(tcfg, tree, batches)
    ranks = {}
    for world in (2, 4):
        payload = dict(config=tcfg, params=tree, batches=batches, runs=[
            dict(name=f"{name}-{remat}", plan=plan, sp_attn=attn,
                 remat_policy=remat)
            for name, (plan, attn) in PLANS.items()
            if JMeshPlan(**plan).size == world for remat in REMATS])
        for r, res in enumerate(workers.run(
                workers.train_steps, payload, world,
                str(tmp_path_factory.mktemp(f"tp{world}")))):
            for run, got in res.items():
                ranks.setdefault(run, [None] * world)[r] = got
    return jax_runs, one_rank, ranks


@pytest.mark.parametrize("name, remat", RUNS)
def test_tp_trainer_matches_jax_and_one_rank(runs, name, remat):
    jax_runs, (one, one_params), ranks = runs
    got = ranks[f"{name}-{remat}"]
    for r in got:                # every rank reports the global numbers
        assert r["losses"] == got[0]["losses"]
        assert r["grad_norms"] == got[0]["grad_norms"]
    for loss, norm, (jl, jn), (ol, on) in zip(
            got[0]["losses"], got[0]["grad_norms"], jax_runs[name], one):
        assert loss == pytest.approx(jl, rel=1e-4)
        assert norm == pytest.approx(jn, rel=1e-4)
        assert loss == pytest.approx(ol, rel=1e-5)
        assert norm == pytest.approx(on, rel=1e-5)
    # the gathered parameters after 3 steps, leaf by leaf in shape and
    # within 1e-5 of the one-rank trainer's
    for a, b in zip(jax.tree.leaves(got[0]["params"]),
                    jax.tree.leaves(one_params)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# ---- train_llama under TDAPI_MESH_PLAN --------------------------------------

def test_tp2_quiesce_parks_every_rank_and_resumes_gapless(tmp_path):
    """quiesce_and_resume under {"tp": 2}."""
    quiesce_and_resume(tmp_path, '{"tp": 2}')


def test_tp_checkpoint_resumes_across_plans(tmp_path):
    """2 steps under {"tp": 2}, 2 more on one rank, 2 more under {"fsdp":
    2}: resume_across."""
    resume_across(tmp_path, ['{"tp": 2}', "", '{"fsdp": 2}'])
