"""The control plane driving a PyTorch workload: the torch twin of
tests/test_migration.py::test_e2e_mid_training_patch_loses_zero_steps.
The JAX daemon (App, the process backend) runs `python -m
gpu_docker_api_tpu_torch.workloads.train_llama --device cpu` in a
replicaSet; a REST tpuCount patch (1 -> 4 chips) mid-training is quiesced
(SIGUSR1: checkpoint, marker, ack, park), and the metrics.jsonl step
sequence has no gap across the two generations. The test imports both
packages; the workload it launches imports only the port."""

import os
import sys

import pytest

from gpu_docker_api_tpu.server.app import App
from gpu_docker_api_tpu.topology import make_topology
from test_migration import _call, _read_metrics, _steps, _wait_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def served_app(tmp_path):
    a = App(state_dir=str(tmp_path / "state"), backend="process",
            addr="127.0.0.1:0", port_range=(47300, 47400),
            topology=make_topology("v5p-8"), api_key="", cpu_cores=8)
    a.start()
    yield a
    a.stop()


def _launch_torch_training(app, steps=60, checkpoint_every=7):
    vol = _call(app, "POST", "/api/v1/volumes",
                {"name": "jobdata", "size": "2GB"})["data"]
    mountpoint = vol["mountpoint"]
    env = [f"PYTHONPATH={REPO}", "OMP_NUM_THREADS=1", "TDAPI_QUIESCE=1"]
    # relative --workdir: resolved against the container rootfs, where the
    # bind is a symlink onto the volume mountpoint
    cmd = [sys.executable, "-m",
           "gpu_docker_api_tpu_torch.workloads.train_llama", "--device",
           "cpu", "--config", "tiny", "--steps", str(steps),
           "--checkpoint-every", str(checkpoint_every), "--batch", "2",
           "--seq", "32", "--workdir", "root/foo-tmp"]
    resp = _call(app, "POST", "/api/v1/replicaSet", {
        "imageName": "python", "replicaSetName": "train", "tpuCount": 1,
        "env": env, "cmd": cmd,
        "binds": [{"src": mountpoint, "dest": "/root/foo-tmp"}]})
    assert resp["code"] == 200, resp
    return os.path.join(mountpoint, "metrics.jsonl")


@pytest.mark.slow
def test_e2e_torch_mid_training_patch_loses_zero_steps(served_app):
    """A 1 -> 4 chip patch of a torch train_llama run with quiesce on: the
    step sequence is gapless across the migration (each record one step
    after the previous; no replay, no hole), the quiesce checkpoint marker
    is in the stream, and the control plane recorded a quiesced
    replace."""
    app = served_app
    metrics = _launch_torch_training(app)
    _wait_metrics(metrics, lambda rs: max(_steps(rs), default=0) >= 10)

    resp = _call(app, "PATCH", "/api/v1/replicaSet/train",
                 {"tpuPatch": {"tpuCount": 4}})
    assert resp["code"] == 200, resp
    assert len(resp["data"]["tpuChips"]) == 4

    pre = max(_steps(_read_metrics(metrics)))
    recs = _wait_metrics(metrics,
                         lambda rs: max(_steps(rs), default=0) > pre)
    seq = _steps(recs)
    assert seq == list(range(1, len(seq) + 1)), seq
    assert any(r.get("quiesced") for r in recs if "checkpoint" in r)
    evts = _call(app, "GET", "/api/v1/events?limit=200")["data"]["events"]
    copied = [e for e in evts if e["op"] == "replace.copied"]
    assert copied and copied[-1]["quiesced"] is True
    _call(app, "DELETE", "/api/v1/replicaSet/train")
