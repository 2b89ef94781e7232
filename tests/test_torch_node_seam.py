"""PyTorch port, the GPU seam's node layer end to end on the CPU: a card
scheduler over a store grants one card of an explicit topology, the
process backend launches the port's trainer with that grant, and the
grant's release persists.

1. GpuScheduler over a tmp MVCCStore (writes through the write-behind
   queue) grants 1 card with a dp=1 plan;
2. ProcessBackend runs `python -m gpu_docker_api_tpu_torch.workloads.
   train_llama --device cpu --config tiny --steps 3` with env_for's env;
3. its metrics.jsonl losses equal an in-process run of the same argv
   within 1e-6;
4. after the stop and the release (the queue drained), a scheduler rebuilt
   from the store sees the card free, and the state key's history holds
   the grant and the release at two revisions.
"""

import json
import os
import signal
import sys

import pytest
import torch

from gpu_docker_api_tpu_torch.backend import ProcessBackend
from gpu_docker_api_tpu_torch.dtos import ContainerSpec
from gpu_docker_api_tpu_torch.meshplan import PlanSpec
from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
from gpu_docker_api_tpu_torch.store import MVCCStore, StateClient
from gpu_docker_api_tpu_torch.topology import make_topology
from gpu_docker_api_tpu_torch.workloads import train_llama
from gpu_docker_api_tpu_torch.workqueue import WorkQueue

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--device", "cpu", "--config", "tiny", "--batch", "2", "--seq", "16",
        "--steps", "3", "--checkpoint-every", "3"]
LOSS_TOL = 1e-6
STATE_KEY = "/tpu-docker-api/apis/v1/tpus/tpuStatusMap"


@pytest.fixture
def keep_sigusr1():
    """train_llama.main installs the quiesce handler; give the old one back."""
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["step"], r["loss"]) for r in recs if "step" in r]


def test_a_granted_card_runs_the_trainer(tmp_path, keep_sigusr1):
    wal = str(tmp_path / "state.wal")
    client = StateClient(MVCCStore(wal_path=wal))
    wq = WorkQueue(client)
    wq.start()
    sched = GpuScheduler(client, wq, topology=make_topology("h100-2"))
    grant = sched.apply(1, "trainer", plan=PlanSpec())
    env = sched.env_for(grant, plan=PlanSpec())
    assert grant == [0] and env["CUDA_VISIBLE_DEVICES"] == "0"
    assert json.loads(env["TDAPI_MESH_PLAN"]) == PlanSpec().to_json()

    backend = ProcessBackend(str(tmp_path / "backend"))
    try:
        spec = ContainerSpec(
            cmd=[sys.executable, "-m",
                 "gpu_docker_api_tpu_torch.workloads.train_llama", *ARGV],
            env=[f"PYTHONPATH={REPO}", "OMP_NUM_THREADS=1"],
            tpu_chips=grant, tpu_env=env,
            devices=sched.device_paths(grant),
            memory_bytes=8 * 1024 ** 3, restart_policy="no")
        backend.create("trainer-1", spec)
        backend.start("trainer-1")
        rc = backend.wait("trainer-1", timeout=600)
        root = backend.inspect("trainer-1").upper_dir
        log = backend.log_text("trainer-1")
        assert rc == 0, log[-3000:]
        got = _losses(root)
        backend.stop("trainer-1")
        backend.remove("trainer-1")
    finally:
        backend.close()

    assert train_llama.main(ARGV + ["--workdir", str(tmp_path / "here")]) == 0
    want = _losses(str(tmp_path / "here"))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= LOSS_TOL

    sched.restore(grant, "trainer")
    assert wq.join(timeout=30)
    wq.close()
    client.store.close()
    reopened = StateClient(MVCCStore(wal_path=wal))
    hist = reopened.store.history(STATE_KEY)
    # the grant, then the release, each at its own revision
    assert [json.loads(kv.value)["status"]["0"] for kv in hist[-2:]] == \
        ["trainer", None]
    assert hist[-2].mod_revision < hist[-1].mod_revision
    again = GpuScheduler(reopened)
    assert again.status == {0: None, 1: None}
    assert again.topology.serialize() == sched.topology.serialize()
    reopened.store.close()
