"""PyTorch port, sequence-parallel training on the CPU: Trainer over sp = 2
gloo ranks on `tiny` for 3 steps, with sp_attn "ring" and "ulysses" under
remat "none", "full" and "dots", against the JAX Trainer on
MeshPlan(sp=2) (loss and grad norm within rel 1e-4, the one-device
trainer test's tolerance) and against the port's one-rank Trainer (rel
1e-5); then `train_llama --device cpu --sp 2` (and an sp-only
TDAPI_MESH_PLAN): checkpoints, a SIGUSR1 quiesce of the launcher with its
ranks, and a resume with a gapless step sequence."""

import dataclasses
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
from gpu_docker_api_tpu_torch.models import LLAMA
from gpu_docker_api_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP = 2
STEPS = 3
RUNS = [(attn, remat) for attn in ("ring", "ulysses")
        for remat in ("none", "full", "dots")]


def _setup():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.key(3)))
    batches = [np.random.default_rng(10 + i).integers(0, 256, (2, 32))
               .astype(np.int32) for i in range(STEPS)]
    return jcfg, tcfg, tree, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sp=2 trainer per sp_attn, the port's one-rank trainer, and
    every (sp_attn, remat) run of the port's sp=2 trainer in one group."""
    jcfg, tcfg, tree, batches = _setup()
    jax_runs = {}
    for attn in ("ring", "ulysses"):
        cfg = dataclasses.replace(jcfg, sp_attn=attn)
        tr = jtrain.Trainer.create(cfg, JMeshPlan(sp=SP),
                                   devices=jax.devices()[:SP])
        params = jax.tree.map(jnp.asarray, tree)
        state = {"params": params, "opt_state": tr.optimizer.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        got = []
        for toks in batches:
            state, m = tr.step(state, tr.shard_batch(jnp.asarray(toks)))
            got.append((float(m["loss"]), float(m["grad_norm"])))
        jax_runs[attn] = got
    one = ttrain.Trainer.create(tcfg, device="cpu")
    state = one.state_from_params(convert.params_from_numpy(tree, tcfg))
    one_rank = []
    for toks in batches:
        state, m = one.step(state, one.shard_batch(toks))
        one_rank.append((float(m["loss"]), float(m["grad_norm"])))
    one_params = convert.params_to_numpy(state["params"])
    payload = dict(config=tcfg, params=tree, batches=batches,
                   runs=[dict(name=f"{a}-{r}", sp_attn=a, remat_policy=r)
                         for a, r in RUNS])
    ranks = workers.run(workers.train_steps, payload, SP,
                        str(tmp_path_factory.mktemp("sptrain")))
    return jax_runs, one_rank, one_params, ranks


@pytest.mark.parametrize("attn, remat", RUNS)
def test_sp2_trainer_matches_jax_and_one_rank(runs, attn, remat):
    jax_runs, one_rank, one_params, ranks = runs
    name = f"{attn}-{remat}"
    for r in ranks:              # every rank reports the global numbers
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]
    got = list(zip(ranks[0][name]["losses"], ranks[0][name]["grad_norms"]))
    for (loss, norm), (jl, jn), (ol, on) in zip(got, jax_runs[attn],
                                                 one_rank):
        assert loss == pytest.approx(jl, rel=1e-4)
        assert norm == pytest.approx(jn, rel=1e-4)
        assert loss == pytest.approx(ol, rel=1e-5)
        assert norm == pytest.approx(on, rel=1e-5)
    # the parameters after 3 steps, as the one-device trainer test holds
    # them to JAX: Adam may flip a near-zero gradient's sign (up to ~lr a
    # step); almost every element agrees to 1e-5
    lr = ttrain.TrainConfig().learning_rate
    diffs = np.concatenate([
        np.abs(a - b).ravel() for a, b in zip(
            jax.tree.leaves(ranks[0][name]["params"]),
            jax.tree.leaves(one_params))])
    assert diffs.max() <= 2 * lr * STEPS
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_sp_loss_shares_sum_to_the_global_mean(monkeypatch):
    """loss_fn under an sp group returns this rank's share: its
    log-likelihood sum over B * (S - 1), the last shard one target short;
    the shares sum to the one-device loss. (Attention is local here: a
    size-2 group whose ranks are called one after another in one process
    has no peer, so the forward is patched to the unsharded one.)"""
    _, tcfg, tree, batches = _setup()
    params = convert.params_from_numpy(tree, tcfg)
    toks = torch.from_numpy(batches[0]).long()
    want = float(ttrain.loss_fn(params, toks, tcfg))
    full = tllama.llama_forward(params, toks, tcfg)
    total = 0.0
    for rank in range(SP):
        sp = workers.comm.SPGroup(group=None, rank=rank, size=SP)
        lo = rank * 16

        def forward(p, t, c, impl, sp, remat, fsdp=None, tp=None):
            return full[:, lo:lo + t.shape[1]]

        fam = dataclasses.replace(LLAMA, forward=forward)
        monkeypatch.setattr(ttrain, "family_for", lambda c: fam)
        total += float(ttrain.loss_fn(params, toks, tcfg, sp=sp))
    assert total == pytest.approx(want, rel=1e-6)


# ---- train_llama --sp 2 ----------------------------------------------------------

TINY = ["--device", "cpu", "--config", "tiny", "--batch", "2", "--seq", "16"]


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return ([r for r in recs if "step" in r],
            [r for r in recs if "checkpoint" in r])


def _run_main(args, env=None, timeout=120):
    """train_llama.main(args) in a subprocess of its own session: a hang
    fails here within `timeout`, the launcher and its ranks killed."""
    proc = subprocess.Popen(
        [sys.executable, "-c", MAIN_SCRIPT, REPO, json.dumps(args)],
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err.decode()[-3000:]


MAIN_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from gpu_docker_api_tpu_torch.workloads.train_llama import main
sys.exit(main(json.loads(sys.argv[2])))
"""


def test_main_sp2_trains_checkpoints_and_matches_one_rank(tmp_path):
    """--sp 2 and a TDAPI_MESH_PLAN of sp 2 train the same losses as one
    rank; rank 0 alone writes metrics and checkpoints."""
    one, cli, env = (str(tmp_path / x) for x in ("one", "cli", "env"))
    base = TINY + ["--steps", "2", "--checkpoint-every", "1"]
    _run_main(base + ["--workdir", one])
    _run_main(base + ["--workdir", cli, "--sp", "2"])
    _run_main(base + ["--workdir", env],
              env={"TDAPI_MESH_PLAN": '{"sp": 2}'})
    want = [r["loss"] for r in _records(one)[0]]
    for wd in (cli, env):
        steps, ckpts = _records(wd)
        assert [r["step"] for r in steps] == [1, 2]
        assert [r["loss"] for r in steps] == pytest.approx(want, rel=1e-4)
        assert all(r["devices"] == 2 and r["plan"].endswith("sp=2)")
                   for r in steps)
        assert [r["checkpoint"] for r in ckpts] == [1, 2]
        assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == [
            "1", "2"]


def test_sp2_quiesce_parks_every_rank_and_resumes_gapless(tmp_path):
    """SIGUSR1 to the launcher reaches both ranks; they agree on the step,
    rank 0 writes checkpoint, marker and ack, both park; SIGTERM stops the
    launcher and its ranks; the next generation resumes at the parked
    step with no gap."""
    wd = tmp_path / "run"
    args = TINY + ["--sp", "2", "--steps", "100000", "--checkpoint-every",
                   "100000", "--workdir", str(wd)]
    env = dict(os.environ, CONTAINER_ROOT=str(tmp_path), OMP_NUM_THREADS="1")
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
    assert ckpts == [ckpts[0]] and ckpts[0]["checkpoint"] == parked
    assert ckpts[0]["quiesced"] is True
    ckpt_dir = wd / "checkpoints"
    assert (ckpt_dir / "QUIESCED").read_text() == f"{parked}\n"
    _run_main(TINY + ["--sp", "2", "--workdir", str(wd),
                      "--checkpoint-every", "100000",
                      "--steps", str(parked + 2)])
    steps, _ = _records(str(wd))
    assert [r["step"] for r in steps] == list(range(1, parked + 3))
    assert not (ckpt_dir / "QUIESCED").exists()
