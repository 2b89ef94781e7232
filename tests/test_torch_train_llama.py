"""PyTorch port, workloads/train_llama.py: the workload contract the control
plane relies on — resume with a gapless step sequence, the metrics.jsonl
schema of the JAX workload, the SIGUSR1 quiesce park, the pp launches, and
refusals of what is not yet ported — run on the CPU with --device cpu. The
sp twins (--sp 2 over gloo ranks) are in tests/test_torch_sp_train.py."""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu.workloads import train_llama as jtl
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--config", "tiny", "--batch", "2", "--seq", "16"]


@pytest.fixture
def keep_sigusr1():
    """main() installs the quiesce handler; give the old one back."""
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return ([r for r in recs if "step" in r],
            [r for r in recs if "checkpoint" in r])


def test_main_checkpoints_and_resumes_gapless(tmp_path, keep_sigusr1):
    wd = str(tmp_path / "run")
    base = TINY + ["--checkpoint-every", "2", "--workdir", wd]
    assert ttl.main(base + ["--steps", "4"]) == 0
    assert ttl.main(base + ["--steps", "6"]) == 0
    steps, ckpts = _records(wd)
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5, 6]
    assert [r["checkpoint"] for r in ckpts] == [2, 4, 6]
    assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == [
        "2", "4", "6"]
    assert all(r["devices"] == 1 for r in steps)


def test_resume_replays_the_same_batches(tmp_path, keep_sigusr1):
    """A run cut at step 2 and resumed ends bit-identical to one that ran
    through: (seed, step) batches, exact optimizer state."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttl.main(TINY + ["--checkpoint-every", "2", "--workdir", a,
                     "--steps", "2"])
    ttl.main(TINY + ["--checkpoint-every", "2", "--workdir", a,
                     "--steps", "4"])
    ttl.main(TINY + ["--checkpoint-every", "4", "--workdir", b,
                     "--steps", "4"])
    la = [r["loss"] for r in _records(a)[0]]
    lb = [r["loss"] for r in _records(b)[0]]
    assert la == lb


def _jax_records(tmp_path, monkeypatch, quiesce):
    """Records the JAX workload's loop writes, driven by stubs (no model)."""

    class Trainer:
        def step(self, state, tokens):
            return state, {"loss": 1.0}

    class Quiesce:
        requested = quiesce

        @staticmethod
        def park():
            raise StopIteration   # leave the loop instead of parking

    monkeypatch.setenv("CONTAINER_ROOT", str(tmp_path))
    path = tmp_path / "jax.jsonl"
    args = argparse.Namespace(steps=2, checkpoint_every=2)
    with open(path, "w", encoding="utf-8") as f:
        try:
            jtl._train_loop(args, Trainer(), None, 0, iter([0, 0]), f,
                            str(tmp_path / "ck"), 1, JMeshPlan(), None,
                            lambda *a: None, quiesce=Quiesce())
        except StopIteration:
            pass
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_schema_matches_jax(tmp_path, monkeypatch, keep_sigusr1):
    wd = str(tmp_path / "run")
    ttl.main(TINY + ["--checkpoint-every", "2", "--workdir", wd,
                     "--steps", "2"])
    steps, ckpts = _records(wd)
    jrecs = _jax_records(tmp_path, monkeypatch, quiesce=False)
    assert set(steps[0]) == set(jrecs[0])
    assert set(ckpts[0]) == set(jrecs[-1])
    assert steps[0]["plan"] == jrecs[0]["plan"]


def test_main_without_device_cpu_raises_when_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttl.main(["--config", "tiny", "--steps", "1",
                  "--workdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("extra, env", [
    ([], {"TPU_WORKER_HOSTNAMES": "w0,w1"}),
])
def test_not_yet_ported_is_refused(tmp_path, monkeypatch, extra, env):
    """A multi-worker grant (the pp launches: test_pp_is_launched)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttl.main(TINY + ["--steps", "1", "--workdir", str(tmp_path)] + extra)


@pytest.mark.parametrize("extra, env, plan", [
    (["--tp", "2", "--pp", "2"], {}, JMeshPlan(pp=2, tp=2)),
    (["--pp", "2"], {}, JMeshPlan(pp=2)),
    (["--family", "moe", "--pp", "2"], {}, JMeshPlan(pp=2)),
    ([], {"TDAPI_MESH_PLAN": '{"ep": 2, "pp": 2}'}, JMeshPlan(pp=2, ep=2)),
    ([], {"TDAPI_MESH_PLAN": '{"dp": 2, "pp": 2}'}, JMeshPlan(dp=2, pp=2)),
])
def test_pp_is_launched(tmp_path, monkeypatch, extra, env, plan):
    """What was refused before pp was ported now launches its ranks with
    the plan asked for (the runs: tests/test_torch_pp_train.py)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launched = []
    monkeypatch.setattr(ttl, "_launch",
                        lambda args, argv, p: launched.append(p) or 0)
    assert ttl.main(TINY + ["--steps", "1", "--workdir", str(tmp_path)]
                    + extra) == 0
    assert [str(p) for p in launched] == [str(plan)]


def test_one_device_mesh_plan_is_accepted(tmp_path, monkeypatch,
                                          keep_sigusr1):
    monkeypatch.setenv("TDAPI_MESH_PLAN", '{"dp": 1}')
    assert ttl.main(TINY + ["--steps", "1", "--workdir", str(tmp_path)]) == 0


QUIESCE_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from gpu_docker_api_tpu_torch.workloads.train_llama import main
sys.exit(main(["--device", "cpu", "--config", "tiny", "--batch", "2",
               "--seq", "16", "--steps", "100000", "--checkpoint-every",
               "100000", "--workdir", sys.argv[2]]))
"""


def test_sigusr1_quiesce_parks_with_ack(tmp_path, monkeypatch, keep_sigusr1):
    wd = tmp_path / "run"
    env = dict(os.environ, CONTAINER_ROOT=str(tmp_path),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", QUIESCE_SCRIPT, REPO,
                             str(wd)], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
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
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    steps, ckpts = _records(str(wd))
    assert steps[-1]["step"] == parked
    assert ckpts == [ckpts[0]] and ckpts[0]["checkpoint"] == parked
    assert ckpts[0]["quiesced"] is True
    jrecs = _jax_records(tmp_path, monkeypatch, quiesce=True)
    assert set(ckpts[0]) == set(jrecs[-1])
    ckpt_dir = wd / "checkpoints"
    assert (ckpt_dir / "QUIESCED").read_text() == f"{parked}\n"
    assert (ckpt_dir / str(parked) / "state.pt").exists()
    # the next generation resumes at the parked step and consumes the marker
    assert ttl.main(TINY + ["--workdir", str(wd), "--checkpoint-every",
                            "100000", "--steps", str(parked + 2)]) == 0
    steps, _ = _records(str(wd))
    assert [r["step"] for r in steps] == list(range(1, parked + 3))
    assert not (ckpt_dir / "QUIESCED").exists()
