"""PyTorch port, MoE training over ranks on the CPU: the Trainer over gloo
ranks on MoE `tiny` (f32, capacity factor 0.5, so choices drop) for 3
steps under ep=2, ep=4, dp=2 x ep=2 (also with accum_steps=2), fsdp=2 x
ep=2, ep=2 x tp=2, sp=2 x ep=2 (ring and Ulysses) and, without ep, dp=2,
fsdp=2, tp=2 and sp=2, each under remat "none" and "dots", against the JAX
Trainer on the same MeshPlan over forced CPU devices (loss and grad norm
within rel 1e-4; JAX's MoE attends through the ring under sp) and against
the port's one-rank Trainer (rel 1e-5; the gathered params within 1e-5).
Planted faults, a rank-local capacity and prefix (ep=2, dp=2) and a
rank-major prefix under sp (sp=2 x ep=2), must fail the comparison with
JAX. Then `train_llama --family moe --device cpu` under TDAPI_MESH_PLAN
{"ep": 2}: a SIGUSR1 quiesce with a gapless resume, and a resume across
plans ({"ep": 2}, one rank, {"fsdp": 2}) equal to an uninterrupted
one-rank run; and the un-planned launches that take ep."""

import dataclasses
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl
from test_torch_fsdp_train import quiesce_and_resume, resume_across

torch.set_num_threads(1)

STEPS = 3
CF = 0.5
MOE = ["--family", "moe"]
# name: (plan, sp_attn, accum_steps); the remat policies run under each
PLANS = {
    "ep2": ({"ep": 2}, "ring", 1),
    "ep4": ({"ep": 4}, "ring", 1),
    "dp2xep2": ({"dp": 2, "ep": 2}, "ring", 1),
    "dp2xep2-accum2": ({"dp": 2, "ep": 2}, "ring", 2),
    "fsdp2xep2": ({"fsdp": 2, "ep": 2}, "ring", 1),
    "ep2xtp2": ({"ep": 2, "tp": 2}, "ring", 1),
    "ep2xsp2-ring": ({"ep": 2, "sp": 2}, "ring", 1),
    "ep2xsp2-ulysses": ({"ep": 2, "sp": 2}, "ulysses", 1),
    "dp2": ({"dp": 2}, "ring", 1),
    "fsdp2": ({"fsdp": 2}, "ring", 1),
    "tp2": ({"tp": 2}, "ring", 1),
    "sp2": ({"sp": 2}, "ring", 1),
}
REMATS = ("none", "dots")
RUNS = [(name, remat) for name in PLANS for remat in REMATS]
# name: (the plan whose JAX run it must miss, the fault)
FAULTS = {"ep2-rank-local": ("ep2", "rank_local"),
          "dp2-rank-local": ("dp2", "rank_local"),
          "ep2xsp2-rank-major": ("ep2xsp2-ring", "rank_major")}


def _setup():
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), capacity_factor=CF)
    tcfg = dataclasses.replace(tmoe.MoEConfig.tiny(), capacity_factor=CF)
    tree = jax.tree.map(np.asarray, jmoe.init_params(jcfg, jax.random.key(5)))
    batches = [np.random.default_rng(50 + i).integers(0, 256, (8, 32))
               .astype(np.int32) for i in range(STEPS)]
    return jcfg, tcfg, tree, batches


def _jax_run(jcfg, tree, batches, plan, accum):
    plan = JMeshPlan(**plan)
    tr = jtrain.Trainer.create(jcfg, plan,
                               tc=jtrain.TrainConfig(accum_steps=accum),
                               devices=jax.devices()[:plan.size])
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    got = []
    for toks in batches:
        state, m = tr.step(state, tr.shard_batch(jnp.asarray(toks)))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got


def _one_rank(tcfg, tree, batches, accum):
    """The port's one-rank run, and the keep mask of its first layer's
    first routing (to show that choices drop)."""
    one = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(
        accum_steps=accum), device="cpu")
    state = one.state_from_params(convert.params_from_numpy(tree, tcfg))
    route, keeps = tmoe._route, []

    def recording(*args):
        out = route(*args)
        keeps.append(out[6])
        return out
    tmoe._route = recording
    got = []
    try:
        for toks in batches:
            state, m = one.step(state, one.shard_batch(toks))
            got.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        tmoe._route = route
    return got, convert.params_to_numpy(state["params"]), keeps[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per plan the JAX trainer's numbers, the port's one-rank trainer's
    (accum 1 and 2), and every run of the port over its ranks (the plans of
    2 ranks in one group, those of 4 in another, with the planted faults),
    the ranks running while JAX compiles."""
    jcfg, tcfg, tree, batches = _setup()
    ranks, failed = {}, []

    def over_ranks():
        try:
            for world in (2, 4):
                specs = [dict(name=f"{name}-{remat}", plan=plan,
                              sp_attn=attn, remat_policy=remat,
                              accum_steps=accum)
                         for name, (plan, attn, accum) in PLANS.items()
                         if MeshPlan(**plan).size == world
                         for remat in REMATS]
                specs += [dict(name=name, plan=PLANS[of][0],
                               sp_attn=PLANS[of][1], remat_policy="none",
                               fault=fault)
                          for name, (of, fault) in FAULTS.items()
                          if MeshPlan(**PLANS[of][0]).size == world]
                payload = dict(config=tcfg, params=tree, batches=batches,
                               runs=specs)
                for r, res in enumerate(workers.run(
                        workers.train_steps, payload, world,
                        str(tmp_path_factory.mktemp(f"moe{world}")))):
                    for run, got in res.items():
                        ranks.setdefault(run, [None] * world)[r] = got
        except Exception as e:         # raised again in the test process
            failed.append(e)

    ranks_thread = threading.Thread(target=over_ranks)
    ranks_thread.start()
    # ring and Ulysses share one JAX run; three compile at a time
    keys = {(json.dumps(plan, sort_keys=True), accum)
            for plan, _, accum in PLANS.values()}
    with ThreadPoolExecutor(3) as pool:
        jax_runs = dict(zip(keys, pool.map(lambda key: _jax_run(
            jcfg, tree, batches, json.loads(key[0]), key[1]), keys)))
    one_rank = {a: _one_rank(tcfg, tree, batches, a) for a in (1, 2)}
    ranks_thread.join()
    if failed:
        raise failed[0]
    by_name = {name: jax_runs[(json.dumps(plan, sort_keys=True), accum)]
               for name, (plan, _, accum) in PLANS.items()}
    return by_name, one_rank, ranks


def _rel(a, b):
    return abs(a / b - 1)


@pytest.mark.parametrize("name, remat", RUNS)
def test_moe_trainer_over_ranks_matches_jax_and_one_rank(runs, name, remat):
    jax_runs, one_rank, ranks = runs
    accum = PLANS[name][2]
    one, one_params, keep = one_rank[accum]
    assert not bool(keep.all()), "capacity must drop choices here"
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
    for a, b in zip(jax.tree.leaves(got[0]["params"]),
                    jax.tree.leaves(one_params)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", FAULTS)
def test_planted_routing_faults_miss_jax(runs, name):
    """A rank-local capacity and prefix, and a rank-major prefix under sp,
    each move some step's loss or grad norm past the rel 1e-4 that the
    right route meets."""
    jax_runs, _, ranks = runs
    got = ranks[name][0]
    want = jax_runs[FAULTS[name][0]]
    worst = max(max(_rel(l, jl), _rel(n, jn)) for l, n, (jl, jn) in zip(
        got["losses"], got["grad_norms"], want))
    assert worst > 1e-4, f"{name}: within {worst} of JAX"


# ---- train_llama --family moe over ranks ------------------------------------

def test_moe_ep2_quiesce_parks_every_rank_and_resumes_gapless(tmp_path):
    """quiesce_and_resume of --family moe under {"ep": 2}."""
    quiesce_and_resume(tmp_path, '{"ep": 2}', MOE)


def test_moe_checkpoint_resumes_across_plans(tmp_path):
    """--family moe: 2 steps under {"ep": 2}, 2 more on one rank, 2 more
    under {"fsdp": 2}: resume_across."""
    resume_across(tmp_path, ['{"ep": 2}', "", '{"fsdp": 2}'], MOE)


@pytest.mark.parametrize("argv, want", [
    (["--ep", "2"], MeshPlan(ep=2)),
    (["--ep", "2", "--tp", "2"], MeshPlan(ep=2, tp=2)),
    (["--ep", "2", "--sp", "2"], MeshPlan(ep=2, sp=2)),
])
def test_unplanned_cpu_launch_takes_ep(argv, want):
    """On --device cpu the un-planned plan is what the flags ask, ep
    included; on a host of n cards JAX's plan for MoE is best_tp_for's tp
    with the rest on fsdp (tp=4 on four cards)."""
    args = ttl._parser().parse_args(["--device", "cpu", *MOE, *argv])
    assert ttl._unplanned(args) == want
    assert ttl.unplanned_plan(4, 0, 1) == MeshPlan(tp=4)
    assert ttl.unplanned_plan(4, 0, 1, ep=2) == MeshPlan(ep=2, tp=2)
    assert ttl.unplanned_plan(8, 0, 1, ep=4) == MeshPlan(ep=4, tp=2)
