"""PyTorch port, multi-worker training on the CPU: the control plane's
multi-worker contract (TPU_WORKER_HOSTNAMES, TPU_WORKER_ID,
JAX_COORDINATOR_ADDRESS) turned into ranks, each "worker" a process formed
from its own contract env on 127.0.0.1 that runs its local gloo ranks.

- the contract -> (world, global rank, local device) mapping, worker-major,
  for 1-4 workers, on the CPU and (a faked card count) on cuda, and the
  raising cases: ranks that do not divide over the workers, a worker index
  outside the contract, a malformed one, cuda without a card;
- llama `tiny` (f32) under TDAPI_MESH_PLAN {"fsdp": 2, "tp": 2} over 2
  workers x 2 ranks for 2 steps: losses and grad norms against the JAX
  Trainer on the same plan over forced CPU devices within
  test_torch_tp_train.py's rel 1e-4, every rank equal; MoE `tiny` (capacity
  factor 0.5) at ep=2 over 2 workers x 1 rank against the JAX Trainer
  within test_torch_moe_ranks_train.py's rel 1e-4;
- `train_llama --device cpu` on 2 workers: records carry the
  "process": "0/2" field, global rank 0 alone writes metrics and one
  gathered checkpoint, which a one-worker run resumes without a gap.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.distributed import (
    cluster_spec_from_env as jax_cluster_spec,
)
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu_torch import distributed
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe as tmoe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
REL = 1e-4          # test_torch_tp_train.py / test_torch_moe_ranks_train.py


# ---- the contract -> ranks ------------------------------------------------

@pytest.mark.parametrize("workers_n", [1, 2, 3, 4])
@pytest.mark.parametrize("local", [1, 2])
def test_contract_maps_to_worker_major_ranks(workers_n, local):
    """Each worker's ranks are worker x local + i over a world of workers x
    local ranks (JAX's jax.devices() order, which make_mesh reshapes):
    every global rank once, tp and sp (the innermost axes) inside a
    worker; on the CPU every rank on the CPU."""
    seen = []
    for w in range(workers_n):
        env = workers.cluster_env(w, workers_n, "10.0.0.9:4000")
        spec = distributed.cluster_spec_from_env(env)
        if workers_n == 1:
            assert spec is None                  # one worker: no cluster
            spec = {"coordinator": "10.0.0.9:4000", "num_processes": 1,
                    "process_id": 0}
        else:
            assert spec == jax_cluster_spec(env)  # the JAX package's parse
        c = distributed.cluster_layout(spec, "cpu", workers_n * local)
        assert (c.world, c.local, c.worker) == (workers_n * local, local, w)
        assert list(c.ranks) == [w * local + i for i in range(local)]
        assert c.init_method == "tcp://10.0.0.9:4000"
        assert all(c.device(r, "cpu") == torch.device("cpu")
                   for r in c.ranks)
        seen += list(c.ranks)
    assert seen == list(range(workers_n * local))


@pytest.mark.parametrize("workers_n", [2, 4])
def test_on_cuda_a_worker_holds_its_visible_cards(monkeypatch, workers_n):
    """On cuda `local` is torch.cuda.device_count() (the grant's visible
    cards) and rank worker x local + i runs on cuda:i."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    spec = distributed.cluster_spec_from_env(
        workers.cluster_env(1, workers_n, "h:1"))
    c = distributed.cluster_layout(spec, "cuda")
    assert (c.world, c.local, list(c.ranks)) == (2 * workers_n, 2, [2, 3])
    assert [c.device(r, "cuda") for r in c.ranks] == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("env, n_dev, error", [
    (workers.cluster_env(0, 2, "h:1"), 3, "do not divide over 2 workers"),
    (workers.cluster_env(0, 4, "h:1"), 2, "do not divide over 4 workers"),
    (workers.cluster_env(2, 2, "h:1"), 2, "outside the contract's 2"),
    (dict(workers.cluster_env(0, 2, "h:1"), TPU_WORKER_ID="-1"), 2,
     "outside the contract's 2"),
    (dict(workers.cluster_env(0, 2, "h:1"), TPU_WORKER_ID="w1"), 2,
     "unparsable TPU_WORKER_ID"),
])
def test_bad_contracts_raise(env, n_dev, error):
    with pytest.raises(ValueError, match=error):
        spec = distributed.cluster_spec_from_env(env)
        distributed.cluster_layout(spec, "cpu", n_dev)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    spec = distributed.cluster_spec_from_env(
        workers.cluster_env(0, 2, "h:1"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.cluster_layout(spec, "cuda")


# ---- the Trainer over workers against JAX's ---------------------------------

def _jax_run(jcfg, tree, batches, plan):
    plan = JMeshPlan(**plan)
    tr = jtrain.Trainer.create(jcfg, plan, devices=jax.devices()[:plan.size])
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    got = []
    for toks in batches:
        state, m = tr.step(state, tr.shard_batch(jnp.asarray(toks)))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got


RUNS = {  # name: (family, plan, workers, ranks)
    "llama fsdp2xtp2": ("llama", {"fsdp": 2, "tp": 2}, 2, 4),
    "moe ep2": ("moe", {"ep": 2}, 2, 2),
}


def _family(name):
    if name == "llama":
        return (jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny(),
                jllama.init_params, (4, 32))
    return (dataclasses.replace(jmoe.MoEConfig.tiny(), capacity_factor=0.5),
            dataclasses.replace(tmoe.MoEConfig.tiny(), capacity_factor=0.5),
            jmoe.init_params, (8, 32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per run the JAX Trainer's numbers and each global rank's (the
    workers running while JAX compiles)."""
    out, threads = {}, []
    for name, (family, plan, workers_n, n_dev) in RUNS.items():
        jcfg, tcfg, init, shape = _family(family)
        tree = jax.tree.map(np.asarray, init(jcfg, jax.random.key(5)))
        batches = [np.random.default_rng(70 + i).integers(0, 256, shape)
                   .astype(np.int32) for i in range(STEPS)]
        payload = dict(config=tcfg, params=tree, batches=batches, runs=[
            dict(name=name, plan=plan, sp_attn="ring",
                 remat_policy="none")])
        tmp = str(tmp_path_factory.mktemp(name.replace(" ", "-")))
        out[name] = {}

        def body(name=name, payload=payload, workers_n=workers_n,
                 n_dev=n_dev, tmp=tmp):
            out[name]["ranks"] = [r[name] for r in workers.run_workers(
                workers.train_steps, payload, workers_n, n_dev, tmp)]
        threads.append(threading.Thread(target=body))
        threads[-1].start()
        out[name]["jax"] = _jax_run(jcfg, tree, batches, plan)
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_over_workers_matches_jax(runs, name):
    got = runs[name]
    assert "ranks" in got, "the workers failed"
    ranks = got["ranks"]
    assert len(ranks) == RUNS[name][3]
    for r in ranks:                 # every rank reports the global numbers
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_norms"] == ranks[0]["grad_norms"]
    for loss, norm, (jl, jn) in zip(ranks[0]["losses"],
                                    ranks[0]["grad_norms"], got["jax"]):
        assert loss == pytest.approx(jl, rel=REL)
        assert norm == pytest.approx(jn, rel=REL)


# ---- train_llama on two workers ----------------------------------------------

def _train_workers(workdir, plan, steps, workers_n=2):
    """`train_llama --device cpu` on workers_n worker processes, each from
    its contract env; -> their exit codes and outputs."""
    coordinator = f"127.0.0.1:{distributed.free_port()}"
    procs = []
    for w in range(workers_n):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   **workers.cluster_env(w, workers_n, coordinator))
        if plan:
            env["TDAPI_MESH_PLAN"] = plan
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "gpu_docker_api_tpu_torch.workloads.train_llama", "--device",
             "cpu", "--config", "tiny", "--steps", str(steps),
             "--checkpoint-every", "2", "--workdir", str(workdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_llama_on_two_workers_writes_once_and_resumes_on_one(tmp_path):
    """TDAPI_MESH_PLAN {"fsdp": 2, "tp": 2} over 2 workers x 2 ranks, 2
    steps: rank 0 alone writes the records (with "process": "0/2") and one
    gathered checkpoint; a one-worker run resumes it at step 3, gapless."""
    outs = _train_workers(tmp_path, '{"fsdp": 2, "tp": 2}', 2)
    assert [code for code, _ in outs] == [0, 0], outs
    assert "done: 2 steps" in outs[0][1]
    assert "done: 2 steps" not in outs[1][1]     # worker 1 holds no rank 0
    recs = _records(tmp_path)
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["process"] == "0/2" and r["devices"] == 4 for r in steps)
    assert [r["checkpoint"] for r in recs if "checkpoint" in r] == [2]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2"]
    one = subprocess.run(
        [sys.executable, "-m", "gpu_docker_api_tpu_torch.workloads."
         "train_llama", "--device", "cpu", "--config", "tiny", "--steps",
         "3", "--workdir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=180, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr
    assert "resumed from checkpoint step 2" in one.stdout
    steps = [r for r in _records(tmp_path) if "step" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert "process" not in steps[-1]
