"""PyTorch port, data parallelism and fully-sharded parameters on the CPU:
the Trainer over gloo ranks on `tiny` (f32) for 3 steps under fsdp=2,
dp=2, dp=2 x fsdp=2 and fsdp=2 x sp=2 (ring), remat "none" and "dots",
and accum_steps=2 under dp=2, against the JAX Trainer on the same MeshPlan
over forced CPU devices (loss and grad norm within rel 1e-4, the
one-device trainer test's tolerance) and against the port's one-rank
Trainer (rel 1e-5; the gathered params within 1e-5 but where Adam flips
a near-zero gradient's sign); then `train_llama
--device cpu` under TDAPI_MESH_PLAN {"fsdp": 2}: checkpoints, a SIGUSR1
quiesce of the launcher with its ranks and a gapless resume, and a resume
across plans (fsdp=2, then one rank, then dp=2) equal to an uninterrupted
one-rank run."""

import json
import os
import signal
import subprocess
import sys
import time

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
from gpu_docker_api_tpu_torch.parallel import mesh as tmesh
from test_torch_sp_train import MAIN_SCRIPT, REPO, TINY, _records, _run_main

torch.set_num_threads(1)

STEPS = 3
# name: (plan, accum_steps); the remat policies run under each
PLANS = {
    "fsdp2": ({"fsdp": 2}, 1),
    "dp2": ({"dp": 2}, 1),
    "dp2-accum2": ({"dp": 2}, 2),
    "dp2xfsdp2": ({"dp": 2, "fsdp": 2}, 1),
    "fsdp2xsp2": ({"fsdp": 2, "sp": 2}, 1),
}
REMATS = ("none", "dots")
RUNS = [(name, remat) for name in PLANS for remat in REMATS]


def _setup():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.key(3)))
    batches = [np.random.default_rng(20 + i).integers(0, 256, (4, 32))
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
    one = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(
        accum_steps=accum), device="cpu")
    state = one.state_from_params(convert.params_from_numpy(tree, tcfg))
    got = []
    for toks in batches:
        state, m = one.step(state, one.shard_batch(toks))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got, convert.params_to_numpy(state["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per plan the JAX trainer's and the one-rank port trainer's numbers,
    and every run of the port over its ranks: the plans of 2 ranks in one
    group, those of 4 in another."""
    jcfg, tcfg, tree, batches = _setup()
    jax_runs = {name: _jax_run(jcfg, tree, batches, plan, accum)
                for name, (plan, accum) in PLANS.items()}
    one_rank = {accum: _one_rank(tcfg, tree, batches, accum)
                for accum in {a for _, a in PLANS.values()}}
    ranks = {}
    for world in (2, 4):
        payload = dict(config=tcfg, params=tree, batches=batches, runs=[
            dict(name=f"{name}-{remat}", plan=plan, accum_steps=accum,
                 sp_attn="ring", remat_policy=remat)
            for name, (plan, accum) in PLANS.items()
            if JMeshPlan(**plan).size == world for remat in REMATS])
        for r, res in enumerate(workers.run(
                workers.train_steps, payload, world,
                str(tmp_path_factory.mktemp(f"fsdp{world}")))):
            for run, got in res.items():
                ranks.setdefault(run, [None] * world)[r] = got
    return jax_runs, one_rank, ranks


@pytest.mark.parametrize("name, remat", RUNS)
def test_sharded_trainer_matches_jax_and_one_rank(runs, name, remat):
    jax_runs, one_rank, ranks = runs
    got = ranks[f"{name}-{remat}"]
    for r in got:                # every rank reports the global numbers
        assert r["losses"] == got[0]["losses"]
        assert r["grad_norms"] == got[0]["grad_norms"]
    one, one_params = one_rank[PLANS[name][1]]
    for loss, norm, (jl, jn), (ol, on) in zip(
            got[0]["losses"], got[0]["grad_norms"], jax_runs[name], one):
        assert loss == pytest.approx(jl, rel=1e-4)
        assert norm == pytest.approx(jn, rel=1e-4)
        assert loss == pytest.approx(ol, rel=1e-5)
        assert norm == pytest.approx(on, rel=1e-5)
    # the gathered parameters after 3 steps, held as the sp and one-device
    # trainer tests hold theirs: Adam may flip a near-zero gradient's sign
    # between two summation orders (up to ~lr a step); almost every element
    # agrees to 1e-5
    lr = ttrain.TrainConfig().learning_rate
    diffs = []
    for a, b in zip(jax.tree.leaves(got[0]["params"]),
                    jax.tree.leaves(one_params)):
        assert a.shape == b.shape
        diffs.append(np.abs(a - b).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * lr * STEPS
    assert np.mean(diffs <= 1e-5) >= 0.999


# ---- train_llama under TDAPI_MESH_PLAN -----------------------------------------

def quiesce_and_resume(tmp_path, plan_json, extra=()):
    """Under TDAPI_MESH_PLAN `plan_json`: SIGUSR1 to the launcher reaches
    every rank; they agree on the step, all gather the state, rank 0
    writes checkpoint, marker and ack, all park; SIGTERM stops them; the
    next generation resumes at the parked step with no gap. `extra`: more
    train_llama flags (--family moe)."""
    wd = tmp_path / "run"
    plan = {"TDAPI_MESH_PLAN": plan_json}
    size = int(np.prod(list(json.loads(plan_json).values())))
    args = TINY + list(extra) + ["--steps", "100000", "--checkpoint-every",
                                 "100000", "--workdir", str(wd)]
    env = dict(os.environ, CONTAINER_ROOT=str(tmp_path), OMP_NUM_THREADS="1",
               **plan)
    proc = subprocess.Popen([sys.executable, "-c", MAIN_SCRIPT, REPO,
                             json.dumps(args)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            start_new_session=True)
    ack = tmp_path / ".quiesced"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if (wd / "metrics.jsonl").exists() and len(
                    (wd / "metrics.jsonl").read_text().splitlines()) >= 2:
                break
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.05)
        proc.send_signal(signal.SIGUSR1)
        while time.time() < deadline and not ack.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.05)
        parked = json.loads(ack.read_text())["step"]
        time.sleep(0.3)
        assert proc.poll() is None          # parked, not exited
        proc.terminate()                    # the control plane's stop
        proc.wait(timeout=60)
        assert proc.returncode == 128 + signal.SIGTERM
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    steps, ckpts = _records(str(wd))
    assert steps[-1]["step"] == parked
    assert all(r["devices"] == size and r["plan"] == str(
        tmesh.MeshPlan(**json.loads(plan_json))) for r in steps)
    assert ckpts == [ckpts[0]] and ckpts[0]["checkpoint"] == parked
    assert ckpts[0]["quiesced"] is True
    ckpt_dir = wd / "checkpoints"
    assert (ckpt_dir / "QUIESCED").read_text() == f"{parked}\n"
    _run_main(TINY + list(extra) + ["--workdir", str(wd),
                                    "--checkpoint-every", "100000",
                                    "--steps", str(parked + 2)], env=plan)
    steps, _ = _records(str(wd))
    assert [r["step"] for r in steps] == list(range(1, parked + 3))
    assert not (ckpt_dir / "QUIESCED").exists()


def resume_across(tmp_path, plans, extra=()):
    """Two steps under each TDAPI_MESH_PLAN of `plans` in turn ("" = one
    rank), each run resuming from the gathered checkpoint the one before
    wrote (what a tpuCount patch does): the losses of an uninterrupted
    one-rank run, no step missing or repeated. `extra`: more train_llama
    flags (--family moe)."""
    one, wd = str(tmp_path / "one"), str(tmp_path / "patched")
    base = ["--device", "cpu", "--config", "tiny", "--batch", "4", "--seq",
            "16", "--checkpoint-every", "1", *extra]
    _run_main(base + ["--workdir", one, "--steps", str(2 * len(plans))])
    for i, plan in enumerate(plans):
        _run_main(base + ["--workdir", wd, "--steps", str(2 * i + 2)],
                  env={"TDAPI_MESH_PLAN": plan})
    want, _ = _records(one)
    got, ckpts = _records(wd)
    steps = list(range(1, 2 * len(plans) + 1))
    assert [r["step"] for r in got] == steps
    assert [r["devices"] for r in got] == [
        int(np.prod(list(json.loads(plan or "{}").values())))
        for plan in plans for _ in range(2)]
    assert [r["loss"] for r in got] == pytest.approx(
        [r["loss"] for r in want], rel=1e-5)
    assert [r["checkpoint"] for r in ckpts] == steps


def test_fsdp2_quiesce_parks_every_rank_and_resumes_gapless(tmp_path):
    """quiesce_and_resume under {"fsdp": 2}."""
    quiesce_and_resume(tmp_path, '{"fsdp": 2}')


def test_checkpoint_resumes_across_plans(tmp_path):
    """2 steps under {"fsdp": 2}, 2 more on one rank, 2 more under {"dp":
    2}: resume_across."""
    resume_across(tmp_path, ['{"fsdp": 2}', "", '{"dp": 2}'])
