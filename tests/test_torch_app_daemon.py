"""The port's daemon as a process (gpu_docker_api_tpu_torch/cli.py), its
offline store tooling against the JAX cli's on the same WAL, the card
identities it keeps across a reboot, and chip_smoke.py's phase 16 at tiny
width on the CPU.

- `python -m gpu_docker_api_tpu_torch.cli --backend mock --topology
  h100-8` serves /ping, runs, patches, stops and deletes a replicaSet over
  REST beside a volume, stops on SIGTERM with its state flushed, and a
  daemon restarted on that state serves the volume back and reconciles
  nothing; its import imports no torch (a control-plane process never
  touches the card's driver).
- `store scrub|backup|restore` answer what the JAX cli answers on the
  same WAL (a backup's path and an installed WAL's path are normalised),
  on the Python engine and on the native one.
- Phase 16 runs its REST drive, the crash at replace.after_quiesce, the
  node-level crash and the reconciling restart over a one-card mock line,
  with `train_llama --config tiny --device cpu` as the trainer.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from gpu_docker_api_tpu_torch.ops import attention as att  # noqa: E402

torch.set_num_threads(1)

ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _daemon(state, port, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_docker_api_tpu_torch.cli", "-b", "mock",
         "--topology", "h100-8", "-a", f"127.0.0.1:{port}", "-s", state,
         "--health-interval", "0", "--cpu-cores", "8", *extra],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while True:
        try:
            if _call(port, "GET", "/ping")[1]["code"] == 200:
                return proc
        except OSError:
            pass
        assert proc.poll() is None, proc.stdout.read().decode()
        assert time.monotonic() < deadline, "the daemon never answered"
        time.sleep(0.05)


def _sigterm(proc):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    return proc.returncode, out.decode()


def test_the_cli_daemon_runs_patches_stops_deletes_and_reboots_clean(
        tmp_path):
    state, port = str(tmp_path / "state"), _free_port()
    proc = _daemon(state, port)
    try:
        _, gpus = _call(port, "GET", "/api/v1/resources/gpus")
        topo = gpus["data"]["tpus"]["topology"]
        assert (topo["acceleratorType"], topo["shape"]) == ("h100-8",
                                                           [8, 1, 1])
        _, ran = _call(port, "POST", "/api/v1/replicaSet", {
            "imageName": "python", "replicaSetName": "job", "tpuCount": 2,
            "memory": "1GB"})
        assert ran["code"] == 200 and ran["data"]["tpuChips"] == [0, 1]
        _, patched = _call(port, "PATCH", "/api/v1/replicaSet/job",
                           {"tpuPatch": {"tpuCount": 4}},
                           {"Idempotency-Key": "k1"})
        assert patched["data"]["version"] == 2
        assert patched["data"]["tpuChips"] == [0, 1, 2, 3]
        _, vol = _call(port, "POST", "/api/v1/volumes",
                       {"name": "keep", "size": "16MB"})
        assert vol["data"]["name"] == "keep-1"
        assert _call(port, "PATCH", "/api/v1/replicaSet/job/stop")[1][
            "code"] == 200
        assert _call(port, "DELETE", "/api/v1/replicaSet/job")[1][
            "code"] == 200
        _, gw = _call(port, "GET", "/api/v1/gateways")
        assert gw["code"] == 200 and gw["data"]["gateways"] == []
    finally:
        rc, log = _sigterm(proc)
    assert rc == 0, log
    assert "state flushed; bye" in log
    proc = _daemon(state, port)
    try:
        _, rep = _call(port, "GET", "/api/v1/reconcile")
        assert rep["data"]["reconcile"]["actions"] == 0
        _, info = _call(port, "GET", "/api/v1/volumes/keep")
        assert info["data"]["info"]["volumeName"] == "keep-1"
        _, gone = _call(port, "GET", "/api/v1/replicaSet/job")
        assert gone["code"] == 1016
        _, hist = _call(port, "GET", "/api/v1/replicaSet/job/history")
        assert hist["code"] == 1017
        _, gpus = _call(port, "GET", "/api/v1/resources/gpus")
        assert gpus["data"]["tpus"]["freeCount"] == 8
    finally:
        rc, log = _sigterm(proc)
    assert rc == 0, log


def test_the_daemon_imports_no_torch():
    """A control-plane process: the cli's whole import chain stays off
    torch, so the daemon can never initialise the card's driver (the warm
    pool's card guard would then start every job cold)."""
    code = ("import sys; import gpu_docker_api_tpu_torch.cli; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'gpu_docker_api_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _store_cli(pkg, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", "store", *args], cwd=REPO,
        env=ENV, capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def wal(tmp_path_factory):
    """A state dir whose WAL the port's daemon wrote: volumes, replicaSets
    and their versions."""
    from gpu_docker_api_tpu_torch.server.app import App
    from gpu_docker_api_tpu_torch.topology import make_topology
    state = str(tmp_path_factory.mktemp("walstate") / "state")
    a = App(state_dir=state, backend="mock", addr="127.0.0.1:0",
            topology=make_topology("h100-4"), api_key="", cpu_cores=4,
            store_maint_records=0)
    from gpu_docker_api_tpu_torch.dtos import (ContainerRun, PatchRequest,
                                               TpuPatch)
    a.replicasets.run_container(ContainerRun(
        imageName="i", replicaSetName="w", tpuCount=1))
    a.replicasets.patch_container("w", PatchRequest(
        tpuPatch=TpuPatch(tpuCount=2)))
    a.volumes.create_volume("v", "16MB")
    a.stop()
    return state


def _norm(text, *paths):
    out = json.loads(text)
    for k, v in list(out.items()):
        for p in paths:
            if isinstance(v, str) and p in v:
                out[k] = v.replace(p, "<path>")
    return out


def test_store_scrub_backup_restore_answer_as_the_jax_cli(wal, tmp_path):
    path = os.path.join(wal, "state.wal")
    outs = {}
    for pkg in ("gpu_docker_api_tpu", "gpu_docker_api_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        scrub = _store_cli(pkg, "scrub", path)
        backup = _store_cli(pkg, "backup", "-s", wal, "-o", str(d / "bk.wal"),
                            "--engine", "python")
        again = _store_cli(pkg, "scrub", str(d / "bk.wal"))
        restore = _store_cli(pkg, "restore", "-s", str(d / "new"), "-f",
                             str(d / "bk.wal"))
        refused = _store_cli(pkg, "restore", "-s", str(d / "new"), "-f",
                             str(d / "bk.wal"))
        outs[pkg] = [(p.returncode, _norm(p.stdout, str(d), wal) if p.stdout
                      else p.stderr.replace(str(d), "<path>"))
                     for p in (scrub, backup, again, restore, refused)]
        with open(d / "bk.wal", "rb") as f:
            outs[pkg].append(f.read())
    assert outs["gpu_docker_api_tpu"] == outs["gpu_docker_api_tpu_torch"]
    assert outs["gpu_docker_api_tpu_torch"][0][0] == 0
    assert outs["gpu_docker_api_tpu_torch"][4][0] == 1   # no --force


def test_store_scrub_flags_a_corrupt_wal_as_the_jax_cli(wal, tmp_path):
    from gpu_docker_api_tpu_torch import faults
    import shutil
    bad = tmp_path / "bad.wal"
    shutil.copy(os.path.join(wal, "state.wal"), bad)
    faults.corrupt_wal(str(bad), "bitflip", line_at=0.5)
    got = {pkg: _store_cli(pkg, "scrub", str(bad))
           for pkg in ("gpu_docker_api_tpu", "gpu_docker_api_tpu_torch")}
    j, t = got["gpu_docker_api_tpu"], got["gpu_docker_api_tpu_torch"]
    assert (t.returncode, json.loads(t.stdout)) == (j.returncode,
                                                    json.loads(j.stdout))
    assert t.returncode == 1


def test_store_backup_on_the_native_engine_answers_as_the_jax_cli(
        wal, tmp_path):
    """`store backup --engine native`: the port's native engine writes the
    backup the JAX cli's native engine writes, byte for byte."""
    outs = {}
    for pkg in ("gpu_docker_api_tpu", "gpu_docker_api_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        out = _store_cli(pkg, "backup", "-s", wal, "-o", str(d / "bk.wal"),
                         "--engine", "native")
        with open(d / "bk.wal", "rb") as f:
            outs[pkg] = (out.returncode, _norm(out.stdout, str(d), wal),
                         f.read())
    assert outs["gpu_docker_api_tpu"] == outs["gpu_docker_api_tpu_torch"]
    assert outs["gpu_docker_api_tpu_torch"][0] == 0


def test_a_rebooted_scheduler_keeps_the_cards_identities(tmp_path):
    """Discovery's UUIDs and names survive the store: a daemon that boots
    from its stored state still reports (and grants) the same cards."""
    from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
    from gpu_docker_api_tpu_torch.store import MVCCStore, StateClient
    from gpu_docker_api_tpu_torch.topology import Chip, GpuTopology
    topo = GpuTopology("h100-2", "h100", (2, 1, 1), chips=[
        Chip(0, (0, 0, 0), "/dev/nvidia3", "GPU-aaaa", "NVIDIA H100"),
        Chip(1, (1, 0, 0), "/dev/nvidia7", "GPU-bbbb", "NVIDIA H100")],
        chips_per_host=2)
    wal_path = str(tmp_path / "state.wal")
    store = MVCCStore(wal_path=wal_path)
    first = GpuScheduler(StateClient(store), topology=topo).get_status()
    store.close()
    store = MVCCStore(wal_path=wal_path)
    again = GpuScheduler(StateClient(store))
    assert again.get_status() == first
    assert [(c["uuid"], c["name"], c["device"]) for c in first["chips"]] == [
        ("GPU-aaaa", "NVIDIA H100", "/dev/nvidia3"),
        ("GPU-bbbb", "NVIDIA H100", "/dev/nvidia7")]
    assert [c.uuid for c in again.topology.chips] == ["GPU-aaaa", "GPU-bbbb"]
    store.close()


# tiny takes tens of ms a step: v1 is still running at the patch, and v2
# at the rollback after its first step
DMN_TINY_STEPS = 80


@pytest.fixture
def keep_sigusr1():
    """train_llama.main installs the quiesce handler; give the old one back."""
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


def test_phase_daemon_at_tiny_width_on_the_cpu(tmp_path, keep_sigusr1):
    """Phase 16 end to end on the CPU at `tiny`, over a one-card mock line:
    the daemon started by its cli, the card over REST, the volume and the
    replicaSet through the port's client, the keyed patch crashed at
    replace.after_quiesce with the checkpoint parked, the node-level crash
    (the daemon and its children's process groups), the restart's boot
    reconcile rolling the replace forward, v2 resuming with no step lost
    and an uninterrupted run's losses, the key's retry replaying v2, the
    REST rollback to v1 while v2 runs (v3 with v1's spec, resumed from
    v2's parked checkpoint, the steps gapless across the three versions),
    serve.py on the trainer's volume serving v3's last checkpoint with the
    greedy tokens of this process's own load, then delete, /metrics, the
    patch's trace stitched across the restart and the rollback's trace."""
    from gpu_docker_api_tpu_torch.workloads import train_llama
    shape = dict(b=2, s=16)
    argv = cs.seam_argv("cpu", "tiny", shape, DMN_TINY_STEPS)
    assert train_llama.main(argv + ["--workdir", str(tmp_path),
                                    "--checkpoint-every", "1000"]) == 0
    steps, _ = cs.read_metrics(str(tmp_path / "metrics.jsonl"))
    handoff = tmp_path / "handoff"
    out = cs.phase_daemon(torch, [r["loss"] for r in steps], device="cpu",
                          mock_topology="h100-1", config="tiny", shape=shape,
                          steps=DMN_TINY_STEPS,
                          want_per_step=dict.fromkeys(att.LAUNCHES, 0),
                          handoff=str(handoff))
    # v1's parked checkpoint outlives the volume's delete, for phase 18
    from gpu_docker_api_tpu_torch.train import STATE_FILE
    assert (handoff / "checkpoints" / str(out["handoff_step"])
            / STATE_FILE).is_file()
    assert out["handoff_step"] == out["quiesce_step"]
    assert out["steps"] == list(range(1, DMN_TINY_STEPS + 1))
    assert out["loss_diffs"] == [0.0] * DMN_TINY_STEPS
    assert 1 <= out["quiesce_step"] < DMN_TINY_STEPS
    assert out["v1_warm"] and out["v2_warm"]
    assert out["retry"] == {"status": 200, "code": 200, "replayed": "true",
                            "version": 2}
    assert out["reconcile"]["containersRecreated"] == ["dmntrainer-2"]
    assert out["quiesce_ack_ms"] > 0 and out["trace"]["spans"] > 0
    assert not out["compute_apps_visible"]
    assert out["rollback"]["version"] == 3
    assert out["rollback"]["tpu_chips"] == [0]
    k, k2 = out["quiesce_steps"]
    assert k == out["quiesce_step"] < k2 < DMN_TINY_STEPS
    assert out["child3"]["rc"] == 0
    assert out["serve"]["step"] == DMN_TINY_STEPS
    assert out["serve"]["tokens_equal"]
    assert out["serve"]["launches"] == dict.fromkeys(att.LAUNCHES, 0)
    assert out["rollback_trace"]["spans"] > 0
