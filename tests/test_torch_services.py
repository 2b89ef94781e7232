"""PyTorch port, the services (gpu_docker_api_tpu_torch/services/) against
JAX's on the same call sequences.

Each case drives one World per package: the ReplicaSet and Volume services
over MockBackend, the CPU and port schedulers, the version maps and an
EventLog on one MVCCStore and write-behind queue; the card scheduler is
JAX's TpuScheduler on an `h100-16` line of chips `(16, 1, 1)` and the
port's GpuScheduler on the same line of cards. Every call's result, or its
error, is recorded beside observations of the backend and the schedulers;
after the queue drains the store's keys and values and the event sequence
are recorded too. The two records must be equal.

One stated mapping normalises the JAX side onto the card's, and nothing
else is normalised:
- the grant env (`tpu_env`, `multihost`): TPU_VISIBLE_CHIPS becomes
  CUDA_VISIBLE_DEVICES, CUDA_DEVICE_ORDER=PCI_BUS_ID is added, the
  libtpu-only variables are dropped (tests/test_torch_topology.py's
  card_env_of);
- the device nodes: /dev/accel<i> becomes /dev/nvidia<i>;
- on a line of several nodes, a card's index in a spec's
  CUDA_VISIBLE_DEVICES and its node are its index on its node (i modulo
  the node's cards: PR 14's local indices, ROADMAP C);
- an error is its class name, Tpu read as Gpu (TpuNotEnoughError is the
  port's GpuNotEnoughError, code 1013), and where a report quotes an
  error's text (a drain's `failed`), its "tpu" sentinel reads "gpu";
- each World's own directory reads as <root>, and wall-clock stamps
  (createTime, an event's ts, durationMs, downtimeMs, copySeconds) are
  dropped.

The cases mirror tests/test_services.py (its three XLA compile-cache cases
become one: the port injects no cache, so env and binds stay as the
request gave them), tests/test_services_failures.py, and the
deterministic regressions of tests/test_races.py; its stress sweep runs on
both packages under one seed with the same invariants (the interleaving
is the threads', so the two sweeps are held to the invariants, not to
each other). The health and reconcile regressions of test_races.py
belong to modules not ported yet. Then the port alone: the span tree of a
run and a patch, and a real `train_llama --device cpu`
child quiesce-patched through the service on the process backend,
resuming gapless with an uninterrupted run's losses.
"""

import json
import os
import random
import threading
import time

import pytest
import torch

from gpu_docker_api_tpu import dtos as jdtos
from gpu_docker_api_tpu import topology as jtopo
from gpu_docker_api_tpu import xerrors as jx
from gpu_docker_api_tpu.backend import MockBackend as JMock
from gpu_docker_api_tpu.events import EventLog as JEvents
from gpu_docker_api_tpu.schedulers import CpuScheduler as JCpu
from gpu_docker_api_tpu.schedulers import PortScheduler as JPorts
from gpu_docker_api_tpu.schedulers import TpuScheduler
from gpu_docker_api_tpu.services import ReplicaSetService as JRs
from gpu_docker_api_tpu.services import VolumeService as JVol
from gpu_docker_api_tpu.services import volume as jvolmod
from gpu_docker_api_tpu.store import MVCCStore as JStore
from gpu_docker_api_tpu.store import StateClient as JClient
from gpu_docker_api_tpu.version import MergeMap as JMerge
from gpu_docker_api_tpu.version import VersionMap as JVersions
from gpu_docker_api_tpu.workqueue import WorkQueue as JQueue
from gpu_docker_api_tpu_torch import dtos as tdtos
from gpu_docker_api_tpu_torch import topology as ttopo
from gpu_docker_api_tpu_torch import xerrors as tx
from gpu_docker_api_tpu_torch.backend import MockBackend as TMock
from gpu_docker_api_tpu_torch.events import EventLog as TEvents
from gpu_docker_api_tpu_torch.schedulers import SHARE_QUANTA
from gpu_docker_api_tpu_torch.schedulers import CpuScheduler as TCpu
from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
from gpu_docker_api_tpu_torch.schedulers import PortScheduler as TPorts
from gpu_docker_api_tpu_torch.services import ReplicaSetService as TRs
from gpu_docker_api_tpu_torch.services import VolumeService as TVol
from gpu_docker_api_tpu_torch.services import volume as tvolmod
from gpu_docker_api_tpu_torch.store import MVCCStore as TStore
from gpu_docker_api_tpu_torch.store import StateClient as TClient
from gpu_docker_api_tpu_torch.version import MergeMap as TMerge
from gpu_docker_api_tpu_torch.version import VersionMap as TVersions
from gpu_docker_api_tpu_torch.workqueue import WorkQueue as TQueue
from test_torch_topology import card_env_of

torch.set_num_threads(1)

N_CARDS = 16
#: wall-clock fields: dropped from both records
CLOCK_KEYS = ("createTime", "ts", "durationMs", "downtimeMs", "copySeconds",
              "at")


def err_name(e: BaseException) -> str:
    return type(e).__name__.replace("Tpu", "Gpu")


class FlakyJMock(JMock):
    """JAX's mock with one-shot start failures (test_services_failures)."""

    def __init__(self, state_dir):
        super().__init__(state_dir)
        self.fail_next_start = False
        self.fail_start_of = ""

    def start(self, name):
        if self.fail_next_start or (self.fail_start_of
                                    and name == self.fail_start_of):
            self.fail_next_start = False
            self.fail_start_of = ""
            raise RuntimeError("injected start failure")
        return super().start(name)


class FlakyTMock(TMock):
    """The port's mock with the same one-shot start failures."""

    def __init__(self, state_dir):
        super().__init__(state_dir)
        self.fail_next_start = False
        self.fail_start_of = ""

    def start(self, name):
        if self.fail_next_start or (self.fail_start_of
                                    and name == self.fail_start_of):
            self.fail_next_start = False
            self.fail_start_of = ""
            raise RuntimeError("injected start failure")
        return super().start(name)


class World:
    """One package's services over its mock backend, on one store."""

    def __init__(self, pkg, tmp_path, per=N_CARDS, cores=16,
                 port_range=(42000, 42100), seed=11, backend=None):
        self.jax = pkg == "jax"
        self.per = per
        self.root = str(tmp_path / pkg)
        os.makedirs(self.root)
        self.d = jdtos if self.jax else tdtos
        self.store = (JStore if self.jax else TStore)()
        client = (JClient if self.jax else TClient)(self.store)
        self.client = client
        self.wq = (JQueue if self.jax else TQueue)(client)
        self.wq.start()
        mock = (FlakyJMock if self.jax else FlakyTMock)
        self.backend = backend or mock(os.path.join(self.root, "state"))
        workers = -(-N_CARDS // per)
        if self.jax:
            topo = jtopo.TpuTopology(f"h100-{N_CARDS}", "h100",
                                     (N_CARDS, 1, 1), chips_per_host=per,
                                     num_workers=workers)
            self.tpu = TpuScheduler(client, self.wq, topology=topo)
        else:
            topo = ttopo.GpuTopology(f"h100-{N_CARDS}", "h100",
                                     (N_CARDS, 1, 1), chips_per_host=per,
                                     num_workers=workers)
            self.tpu = GpuScheduler(client, self.wq, topology=topo)
        self.cpu = (JCpu if self.jax else TCpu)(client, self.wq,
                                                core_count=cores)
        self.ports = (JPorts if self.jax else TPorts)(
            client, self.wq, port_range=port_range, seed=seed)
        vmap = JVersions if self.jax else TVersions
        self.events = (JEvents if self.jax else TEvents)()
        self.rs = (JRs if self.jax else TRs)(
            self.backend, client, self.wq, self.tpu, self.cpu, self.ports,
            vmap("containerVersionMap", client, self.wq),
            (JMerge if self.jax else TMerge)(client, self.wq),
            events=self.events)
        self.vol = (JVol if self.jax else TVol)(
            self.backend, client, self.wq,
            vmap("volumeVersionMap", client, self.wq))
        self.volmod = jvolmod if self.jax else tvolmod
        self.xerrors = jx if self.jax else tx
        self.record = []

    def close(self):
        self.wq.close()

    # ---- normalisation (the one mapping in the module docstring) ----

    def norm(self, x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in CLOCK_KEYS:
                    continue
                if self.jax and k == "tpu_env" and v:
                    v = card_env_of(v)
                    v["CUDA_VISIBLE_DEVICES"] = ",".join(
                        str(int(i) % self.per)
                        for i in v["CUDA_VISIBLE_DEVICES"].split(",") if i)
                if self.jax and k == "devices":
                    v = [f"/dev/accel{int(d[len('/dev/accel'):]) % self.per}"
                         for d in v]
                if self.jax and k == "multihost":
                    v = {w: card_env_of(e) for w, e in v.items()}
                out[k] = self.norm(v)
            return out
        if isinstance(x, (list, tuple)):
            return [self.norm(v) for v in x]
        if isinstance(x, str):
            x = x.replace(self.root, "<root>")
            if not self.jax:
                return x
            for tpu, gpu in (("/dev/accel", "/dev/nvidia"),
                             ("tpu not enough", "gpu not enough"),
                             ("tpu shares oversubscribed",
                              "gpu shares oversubscribed")):
                x = x.replace(tpu, gpu)
            return x
        return x

    # ---- recording ----

    def call(self, label, fn, *a, **kw):
        """Run one call; record its normalised result or its error."""
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the error is the result
            self.record.append((label, "error", err_name(e)))
            return None
        self.record.append((label, "ok", self.norm(out)))
        return out

    def note(self, label, value):
        self.record.append((label, "note", self.norm(value)))

    def state(self, name):
        st = self.backend.inspect(name)
        return {"exists": st.exists, "running": st.running,
                "paused": st.paused, "exit_code": st.exit_code}

    def sched(self):
        status = self.tpu.get_status()
        return {"free": status["freeCount"],
                "owners": {str(c["index"]): c["owner"]
                           for c in status["chips"]},
                "cores": self.cpu.get_status()["usedCount"],
                "ports": self.ports.get_status()["usedPortSet"]}

    def finish(self):
        """The store's keys and values after the queue drains, and the
        events, appended to the record."""
        assert self.wq.join(timeout=30)
        keys = []
        for kv in self.store.range(""):
            try:
                value = json.loads(kv.value)
            except (TypeError, ValueError):
                value = kv.value
            keys.append((kv.key, self.norm(value)))
        self.record.append(("store", "keys", keys))
        self.record.append(("events", "ops", self.norm(
            [{k: v for k, v in e.items() if k != "traceId"}
             for e in self.events.recent()])))
        return self.record

    def run(self, name="demo", tpus=2, cpus=2, ports=1, **kw):
        return self.call(f"run {name}", self.rs.run_container,
                         self.d.ContainerRun(
                             imageName="ubuntu:22.04", replicaSetName=name,
                             tpuCount=tpus, cpuCount=cpus, memory="8GB",
                             containerPorts=["8888"] if ports else [], **kw))

    def patch(self, name, **kw):
        return self.call(f"patch {name}", self.rs.patch_container, name,
                         self.d.PatchRequest(**kw))

    def tpu_patch(self, name, n, plan=None):
        return self.patch(name, tpuPatch=self.d.TpuPatch(n, plan))

    def mem_patch(self, name, mem):
        return self.patch(name, memoryPatch=self.d.MemoryPatch(mem))


# ---- tests/test_services.py --------------------------------------------------

def run_container(w):
    w.run()
    w.note("demo-1", w.state("demo-1"))
    w.note("spec", w.backend.inspect("demo-1").spec.to_json())
    w.note("sched", w.sched())


def run_duplicate_rejected(w):
    w.run()
    w.run()


def run_resource_rollback_on_shortage(w):
    w.run(name="big", tpus=64)
    w.note("sched", w.sched())


def run_zero_tpu_smoke(w):
    w.run(name="smoke", tpus=0, cpus=0, ports=0)
    w.note("smoke-1", w.state("smoke-1"))
    w.note("sched", w.sched())


def patch_tpu_1_to_4(w):
    w.run(name="train", tpus=1)
    w.tpu_patch("train", 4)
    w.note("train-1", w.state("train-1"))
    w.note("train-2", w.state("train-2"))
    w.note("sched", w.sched())


def patch_copies_writable_layer(w):
    w.run(name="data")
    with open(os.path.join(w.backend.inspect("data-1").upper_dir,
                           "ckpt.bin"), "w") as f:
        f.write("step-42")
    w.mem_patch("data", "16GB")
    with open(os.path.join(w.backend.inspect("data-2").upper_dir,
                           "ckpt.bin")) as f:
        w.note("carried", f.read())


def patch_no_change_raises(w):
    w.run(tpus=2)
    w.patch("demo")
    w.tpu_patch("demo", 2)
    w.mem_patch("demo", "8GB")


def patch_shortage_keeps_old_running(w):
    w.run(name="a", tpus=2)
    w.run(name="b", tpus=12)
    w.tpu_patch("a", 8)
    w.note("a-1", w.state("a-1"))
    w.note("sched", w.sched())


def patch_ports_regranted(w):
    w.run(name="p")
    w.mem_patch("p", "1GB")
    w.note("sched", w.sched())


def patch_volume_bind_swap(w):
    v1 = w.call("vol data", w.vol.create_volume, "data", "1GB")
    v2 = w.call("vol bigdata", w.vol.create_volume, "bigdata", "2GB")
    w.call("run j", w.rs.run_container, w.d.ContainerRun(
        imageName="x", replicaSetName="j",
        binds=[w.d.Bind(v1["name"], "/root/foo-tmp")]))
    w.patch("j", volumePatch=w.d.VolumePatch(
        oldBind=w.d.Bind(v1["name"], "/root/foo-tmp"),
        newBind=w.d.Bind(v2["name"], "/root/foo-tmp")))
    w.note("binds", w.backend.inspect("j-2").spec.binds)


def rollback_forward_writes(w):
    w.run(name="r", tpus=1)
    w.tpu_patch("r", 4)
    w.call("rollback", w.rs.rollback_container, "r", 1)
    w.note("sched", w.sched())
    w.call("history", w.rs.get_container_history, "r")


def rollback_same_version_rejected(w):
    w.run(name="r")
    w.call("rollback", w.rs.rollback_container, "r", 1)


def rollback_missing_version(w):
    w.run(name="r")
    w.mem_patch("r", "1GB")
    w.call("rollback", w.rs.rollback_container, "r", 99)


def stop_releases_resources(w):
    w.run(name="s", tpus=4, cpus=4)
    w.call("stop", w.rs.stop_container, "s")
    w.note("s-1", w.state("s-1"))
    w.note("sched", w.sched())


def restart_stopped_is_new_version(w):
    w.run(name="s", tpus=2)
    w.call("stop", w.rs.stop_container, "s")
    w.call("restart", w.rs.restart_container, "s")
    w.note("s-1", w.state("s-1"))
    w.note("s-2", w.state("s-2"))
    w.note("sched", w.sched())


def restart_running_keeps_grant(w):
    w.run(name="s", tpus=2)
    w.call("restart", w.rs.restart_container, "s")
    w.note("s-2", w.state("s-2"))


def pause_continue(w):
    w.run(name="pz")
    w.call("pause", w.rs.pause_container, "pz")
    w.note("paused", w.state("pz-1"))
    w.call("continue", w.rs.startup_container, "pz")
    w.note("continued", w.state("pz-1"))


def execute_and_commit(w):
    w.run(name="e")
    w.call("exec", w.rs.execute_container, "e", ["echo", "hello"])
    w.call("commit", lambda: w.rs.commit_container(
        "e", "snap:v1").startswith("sha256:"))
    w.call("info", w.rs.get_container_info, "e")


def delete_clears_everything(w):
    w.run(name="d", tpus=2)
    w.call("delete", w.rs.delete_container, "d")
    w.note("d-1", w.state("d-1"))
    w.note("sched", w.sched())
    w.call("info", w.rs.get_container_info, "d")
    w.call("history", w.rs.get_container_history, "d")
    w.run(name="d")


def volume_create_patch_grow(w):
    v = w.call("create", w.vol.create_volume, "vol", "1GB")
    with open(os.path.join(v["mountpoint"], "data.bin"), "wb") as f:
        f.write(b"d" * 4096)
    out = w.call("grow", w.vol.patch_volume_size, "vol", "2GB")
    with open(os.path.join(out["mountpoint"], "data.bin"), "rb") as f:
        w.note("migrated", len(f.read()))
    w.call("info", w.vol.get_volume_info, "vol")
    w.call("history", w.vol.get_volume_history, "vol")


def volume_shrink_guard(w):
    v = w.call("create", w.vol.create_volume, "vol", "1GB")
    with open(os.path.join(v["mountpoint"], "big.bin"), "wb") as f:
        f.write(b"x" * 2048)
    w.call("shrink 1KB", w.vol.patch_volume_size, "vol", "1KB")
    w.call("shrink 500MB", w.vol.patch_volume_size, "vol", "500MB")


def volume_duplicate_and_delete(w):
    w.call("create", w.vol.create_volume, "vol", "1GB")
    w.call("create again", w.vol.create_volume, "vol", "1GB")
    w.call("delete", w.vol.delete_volume, "vol")
    w.call("info", w.vol.get_volume_info, "vol")
    w.call("create after", w.vol.create_volume, "vol", "1GB")


def volume_same_size_no_patch(w):
    w.call("create", w.vol.create_volume, "vol", "1GB")
    w.call("same", w.vol.patch_volume_size, "vol", "1GB")


def delete_drops_name_lock_entry(w):
    for i in range(5):
        w.run(name=f"churn{i}", tpus=1, cpus=0, ports=0)
    w.note("locks", sorted(w.rs._name_locks))
    for i in range(5):
        w.call(f"delete {i}", w.rs.delete_container, f"churn{i}")
    w.note("locks", sorted(w.rs._name_locks))
    w.run(name="churn0", tpus=1, cpus=0, ports=0)
    w.note("locks", sorted(w.rs._name_locks))
    w.call("delete", w.rs.delete_container, "churn0")
    w.note("locks", sorted(w.rs._name_locks))


def name_lock_waiter_survives_delete(w):
    w.run(name="victim", tpus=1, cpus=0, ports=0)
    in_delete, release = threading.Event(), threading.Event()
    real_join = w.rs.wq.join

    def slow_join(*a, **kw):
        in_delete.set()
        release.wait(5)
        return real_join(*a, **kw)

    w.rs.wq.join = slow_join
    results = []

    def create_again():
        in_delete.wait(5)
        w.rs.wq.join = real_join
        release.set()
        try:
            results.append(w.rs.run_container(w.d.ContainerRun(
                imageName="ubuntu:22.04", replicaSetName="victim",
                tpuCount=1)))
        except Exception as e:  # noqa: BLE001
            results.append(e)

    t = threading.Thread(target=create_again)
    t.start()
    w.call("delete", w.rs.delete_container, "victim")
    t.join(10)
    w.note("alive", t.is_alive())
    w.note("recreated", results[0]["name"] if results and isinstance(
        results[0], dict) else repr(results))
    w.call("delete again", w.rs.delete_container, "victim")
    w.note("locks", sorted(w.rs._name_locks))


def info_exposes_multihost_launch_plan(w):
    w.run("big", tpus=8)
    w.call("info big", w.rs.get_container_info, "big")
    w.run("small", tpus=2)
    w.call("info small", w.rs.get_container_info, "small")


# ---- tests/test_services_failures.py ----------------------------------------

def failed_replace_reverts_world(w):
    w.run("a", tpus=1)
    w.backend.fail_start_of = "a-2"
    w.tpu_patch("a", 4)
    w.note("a-1", w.state("a-1"))
    w.call("info", w.rs.get_container_info, "a")
    w.note("sched", w.sched())
    w.mem_patch("a", "2GB")
    w.call("history", w.rs.get_container_history, "a")


def failed_first_start_does_not_brick_the_name(w):
    w.backend.fail_next_start = True
    w.run("a", tpus=1)
    w.note("a-1", w.state("a-1"))
    w.note("sched", w.sched())
    w.run("a", tpus=1)
    w.note("a-1 again", w.state("a-1"))


def double_stop_cannot_free_others_chips(w):
    w.run("a", tpus=4, ports=0)
    w.call("stop", w.rs.stop_container, "a")
    w.run("b", tpus=4, ports=0)
    w.call("stop again", w.rs.stop_container, "a")
    w.note("sched", w.sched())


def patch_reuse_keeps_ownership(w):
    w.run("a", tpus=4, ports=0)
    w.run("b", tpus=8, ports=0)
    w.tpu_patch("a", 2)
    w.note("sched", w.sched())


def patch_shortage_unwind_leaves_other_owner_intact(w):
    w.run("a", tpus=2, ports=0)
    w.run("b", tpus=12, ports=0)
    w.tpu_patch("a", 8)
    w.note("sched", w.sched())
    w.note("a-1", w.state("a-1"))


def stop_restart_port_not_stolen(w):
    w.run("a", tpus=0, ports=1)
    w.call("stop", w.rs.stop_container, "a")
    w.note("sched", w.sched())
    w.call("restart", w.rs.restart_container, "a")
    w.note("sched", w.sched())


def restart_shortage_no_stale_free(w):
    w.run("a", tpus=4, ports=0)
    w.call("stop", w.rs.stop_container, "a")
    w.run("b", tpus=14, ports=0)
    w.call("restart", w.rs.restart_container, "a")
    w.note("sched", w.sched())


def delete_exited_container_releases_resources(w):
    w.run("a", tpus=4)
    w.backend.stop("a-1")
    w.note("a-1", w.state("a-1"))
    w.call("delete", w.rs.delete_container, "a")
    w.note("sched", w.sched())


def volume_migration_failure_coherent(w):
    w.call("create", w.vol.create_volume, "vol", "1GB")
    real = w.volmod.move_dir_contents

    def boom(src, dest):
        raise OSError("injected migration failure")

    w.volmod.move_dir_contents = boom
    try:
        w.call("grow", w.vol.patch_volume_size, "vol", "2GB")
    finally:
        w.volmod.move_dir_contents = real
    w.call("info", w.vol.get_volume_info, "vol")
    w.call("history", w.vol.get_volume_history, "vol")
    w.call("grow again", w.vol.patch_volume_size, "vol", "2GB")


# ---- tests/test_races.py: its deterministic regressions ----------------------

def restart_stopped_fractional_under_exhaustion(w):
    w.call("run", w.rs.run_container, w.d.ContainerRun(
        imageName="ubuntu:22.04", replicaSetName="frac", tpuCount=0.25))
    w.call("stop", w.rs.stop_container, "frac")
    hogs = w.call("hog", w.tpu.apply, len(w.tpu.owners()), "hog")
    w.call("restart", w.rs.restart_container, "frac")
    w.call("unhog", w.tpu.restore, hogs, "hog")
    assert w.wq.join(timeout=30)
    snap = w.tpu.snapshot()
    w.note("shares", snap["shares"])


def drain_regrant_on_same_chip_releases_old_quanta(w):
    out = w.call("run", w.rs.run_container, w.d.ContainerRun(
        imageName="ubuntu:22.04", replicaSetName="mig", tpuCount=0.25))
    chip = out["tpuChips"][0]
    w.note("ledger", w.tpu.shares_snapshot())
    orig = w.tpu.cordoned_snapshot
    w.tpu.cordoned_snapshot = lambda: {chip}
    try:
        w.call("drain", w.rs.drain_cordoned)
    finally:
        w.tpu.cordoned_snapshot = orig
    w.note("ledger", w.tpu.shares_snapshot())
    w.call("delete", w.rs.delete_container, "mig")
    w.note("ledger", w.tpu.shares_snapshot())


CASES = [run_container, run_duplicate_rejected,
         run_resource_rollback_on_shortage, run_zero_tpu_smoke,
         patch_tpu_1_to_4, patch_copies_writable_layer,
         patch_no_change_raises, patch_shortage_keeps_old_running,
         patch_ports_regranted, patch_volume_bind_swap,
         rollback_forward_writes, rollback_same_version_rejected,
         rollback_missing_version, stop_releases_resources,
         restart_stopped_is_new_version, restart_running_keeps_grant,
         pause_continue, execute_and_commit, delete_clears_everything,
         volume_create_patch_grow, volume_shrink_guard,
         volume_duplicate_and_delete, volume_same_size_no_patch,
         delete_drops_name_lock_entry, name_lock_waiter_survives_delete,
         failed_replace_reverts_world,
         failed_first_start_does_not_brick_the_name,
         double_stop_cannot_free_others_chips, patch_reuse_keeps_ownership,
         patch_shortage_unwind_leaves_other_owner_intact,
         stop_restart_port_not_stolen, restart_shortage_no_stale_free,
         delete_exited_container_releases_resources,
         volume_migration_failure_coherent,
         restart_stopped_fractional_under_exhaustion,
         drain_regrant_on_same_chip_releases_old_quanta]


def both(tmp_path, case, **kw):
    """Run `case` on each package's World; their records."""
    out = []
    for pkg in ("jax", "port"):
        w = World(pkg, tmp_path, **kw)
        try:
            case(w)
            out.append(w.finish())
        finally:
            w.close()
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_service_case_equals_jax(tmp_path, case):
    jax, port = both(tmp_path, case)
    assert port == jax
    # the case recorded its calls or observations beside the store
    assert any(status in ("ok", "note") for _, status, _ in port)


def test_multihost_launch_plan_equals_jax(tmp_path):
    """A grant spanning nodes carries every node's launch env in info(),
    as JAX's spanning grant does (4 cards a node here)."""
    jax, port = both(tmp_path, info_exposes_multihost_launch_plan, per=4)
    assert port == jax
    info = next(r for label, _, r in port if label == "info big")
    assert len(info["multihost"]) == 2


def test_no_compile_cache_is_injected(tmp_path):
    """JAX's service points every workload at a host-shared XLA cache
    (its three test_xla_cache_* cases); the port's injects nothing: a
    run's and a patch's env and binds are the request's, and the service
    takes no cache directory."""
    w = World("port", tmp_path)
    try:
        assert not hasattr(w.rs, "xla_cache_dir")
        w.run("cached", env=["FOO=1"], binds=[w.d.Bind("/src", "/dst")])
        w.tpu_patch("cached", 4)
        spec = w.rs.get_container_info("cached")["spec"]
        assert [e for e in spec["env"] if not e.startswith(
            "CONTAINER_VERSION=")] == ["FOO=1"]
        assert spec["binds"] == ["/src:/dst"]
        assert not any(e.startswith(("JAX_", "XLA_")) for e in spec["env"])
    finally:
        w.close()


# ---- tests/test_races.py: the stress sweep, on both packages -----------------

def check_invariants(snap) -> list:
    bad = []
    for chip, owners in snap["shares"].items():
        if sum(owners.values()) > SHARE_QUANTA:
            bad.append(f"chip {chip} ledger oversubscribed: {owners}")
        for owner, q in owners.items():
            if not owner or not (1 <= q <= SHARE_QUANTA):
                bad.append(f"chip {chip} bogus grant {owner!r}={q}")
        if owners and snap["status"].get(chip) is not None:
            bad.append(f"chip {chip} whole-owned and share-split")
    return bad


def stress(w, seed, n_workers=6, n_ops=22):
    """tests/test_races.py's sweep on one World: the unexpected errors,
    the invariant violations, and the grants left after deleting all."""
    unexpected, violations = [], []
    stop = threading.Event()

    def checker():
        while not stop.is_set():
            violations.extend(check_invariants(w.tpu.snapshot()))
            if violations:
                return
            time.sleep(0.002)

    def attempt(fn):
        try:
            fn()
        except (w.xerrors.XError, ValueError):
            pass
        except Exception as e:  # noqa: BLE001 — the race signal
            unexpected.append(f"{type(e).__name__}: {e}")

    def worker(wid):
        rng = random.Random(seed * 100 + wid)
        names = [f"w{wid}a", f"w{wid}b", f"w{wid}c"]
        for _ in range(n_ops):
            name = rng.choice(names)
            roll = rng.random()
            count = rng.choice([1, 2, 0.25, 0.5, 0.75])
            if roll < 0.30:
                attempt(lambda: w.rs.run_container(w.d.ContainerRun(
                    imageName="ubuntu:22.04", replicaSetName=name,
                    tpuCount=count,
                    priority=rng.choice(["", "latency", "best_effort"]))))
            elif roll < 0.50:
                attempt(lambda: w.rs.patch_container(
                    name, w.d.PatchRequest(tpuPatch=w.d.TpuPatch(count))))
            elif roll < 0.62:
                attempt(lambda: w.rs.stop_container(name))
            elif roll < 0.72:
                attempt(lambda: w.rs.restart_container(name))
            elif roll < 0.82:
                attempt(lambda: w.rs.delete_container(name))
            elif roll < 0.90:
                other = f"w{(wid + 1) % n_workers}{rng.choice('abc')}"
                attempt(lambda: w.rs.get_container_info(other))
            elif roll < 0.96:
                attempt(w.tpu.get_status)
            else:
                chip = rng.randrange(8)

                def drain_cycle():
                    w.tpu.cordon([chip])
                    try:
                        w.rs.drain_cordoned()
                    finally:
                        w.tpu.uncordon([chip])
                attempt(drain_cycle)

    chk = threading.Thread(target=checker)
    chk.start()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "stress worker wedged (deadlock?)"
    stop.set()
    chk.join(timeout=10)
    for wid in range(n_workers):
        for suffix in "abc":
            try:
                w.rs.delete_container(f"w{wid}{suffix}")
            except w.xerrors.XError:
                pass
    assert w.wq.join(timeout=30)
    snap = w.tpu.snapshot()
    leaked = {"status": {c: o for c, o in snap["status"].items() if o},
              "shares": snap["shares"], "cordoned": sorted(snap["cordoned"]),
              "cores": {c: o for c, o in w.cpu.owners().items() if o},
              "ports": {p: o for p, o in w.ports.owners().items() if o}}
    return unexpected, violations + check_invariants(snap), leaked


@pytest.mark.parametrize("seed", [11, 23])
def test_concurrent_mutation_stress_on_both(tmp_path, seed):
    clean = ([], [], {"status": {}, "shares": {}, "cordoned": [],
                      "cores": {}, "ports": {}})
    for pkg in ("jax", "port"):
        w = World(pkg, tmp_path, cores=64, port_range=(43000, 43400),
                  seed=7)
        try:
            assert stress(w, seed) == clean, pkg
        finally:
            w.close()


# ---- the port alone: spans, and a real trainer through the service ----------

SPAN_FAMILIES = ("test.", "svc.", "intent.", "backend.", "sched.")


def test_span_tree_nests_as_jax_does(tmp_path):
    """svc.* -> intent.* -> backend.* / sched.*: the ops of a run's and a
    patch's traces, each with its parent's op, equal JAX's (the card
    scheduler's spans read sched.tpu.* there)."""
    from gpu_docker_api_tpu.obs import trace as jtrace
    from gpu_docker_api_tpu_torch.obs import trace as ttrace

    def tree(w, tr):
        collector = tr.TraceCollector()
        ops = []
        for label, fn in (("run", lambda: w.run("t", tpus=1)),
                          ("patch", lambda: w.tpu_patch("t", 2))):
            with tr.root_span(collector, f"test.{label}") as root:
                fn()
            spans = collector.get(root.trace_id)["spans"]
            by_id = {s["spanId"]: s["op"] for s in spans}
            # the write-behind queue's spans land as its drainer batches
            # them (timing, not structure): the tree is the rest
            ops.append(sorted(
                (s["op"].replace("sched.tpu.", "sched.gpu."),
                 by_id.get(s["parentId"])) for s in spans
                if s["op"].startswith(SPAN_FAMILIES)))
        return ops

    from gpu_docker_api_tpu.backend import GuardedBackend as JGuarded
    from gpu_docker_api_tpu_torch.backend import GuardedBackend as TGuarded

    jw = World("jax", tmp_path, backend=JGuarded(
        JMock(str(tmp_path / "jax-state"))))
    tw = World("port", tmp_path, backend=TGuarded(
        TMock(str(tmp_path / "port-state"))))
    try:
        jops, tops = tree(jw, jtrace), tree(tw, ttrace)
    finally:
        jw.close()
        tw.close()
    assert tops == jops
    assert {("svc.run", "test.run"), ("intent.run", "svc.run"),
            ("sched.gpu.apply", "intent.run"),
            ("backend.create", "intent.run"),
            ("backend.start", "intent.run")} <= set(tops[0])
    assert {("intent.replace", "svc.patch"),
            ("sched.gpu.apply", "intent.replace"),
            ("backend.stop", "intent.replace"),
            ("backend.start", "intent.replace")} <= set(tops[1])




def test_tiny_trainer_is_quiesce_patched_through_the_service(tmp_path):
    """A real `train_llama --device cpu` child at `tiny` under the port's
    ReplicaSetService on the process backend: a memory patch once step 2
    is recorded quiesces it, the rolling replace starts version 2 on the
    same card, which resumes at the parked step + 1; the step sequence is
    gapless and every loss equals an uninterrupted run's."""
    import sys

    from gpu_docker_api_tpu_torch.backend import ProcessBackend
    from gpu_docker_api_tpu_torch.workloads import train_llama

    steps = 60
    argv = ["--config", "tiny", "--batch", "2", "--seq", "16", "--steps",
            str(steps), "--device", "cpu"]
    ref_dir = tmp_path / "ref"
    assert train_llama.main(argv + ["--workdir", str(ref_dir),
                                    "--checkpoint-every", "1000"]) == 0
    ref = [json.loads(line)["loss"]
           for line in open(ref_dir / "metrics.jsonl") if '"step"' in line]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    backend = ProcessBackend(str(tmp_path / "backend"))
    w = World("port", tmp_path, backend=backend)
    try:
        vol = w.vol.create_volume("runs", "")
        run = w.rs.run_container(tdtos.ContainerRun(
            replicaSetName="tiny", tpuCount=1, meshPlan={"dp": 1},
            memory="8GB", binds=[tdtos.Bind(vol["mountpoint"], "/data")],
            env=["TDAPI_QUIESCE=1", f"PYTHONPATH={repo}",
                 "OMP_NUM_THREADS=1"],
            cmd=[sys.executable, "-m",
                 "gpu_docker_api_tpu_torch.workloads.train_llama", *argv,
                 "--workdir", "data/run", "--checkpoint-every", "1000"]))
        assert run["tpuChips"] == [0]
        metrics = os.path.join(vol["mountpoint"], "run", "metrics.jsonl")
        deadline = time.monotonic() + 120
        while not (os.path.exists(metrics)
                   and sum('"step"' in ln for ln in open(metrics)) >= 2):
            assert backend.inspect("tiny-1").running, backend.log_text(
                "tiny-1")
            assert time.monotonic() < deadline
            time.sleep(0.02)
        patched = w.rs.patch_container("tiny", tdtos.PatchRequest(
            memoryPatch=tdtos.MemoryPatch("4GB")))
        assert patched["version"] == 2 and patched["tpuChips"] == [0]
        copied = [e for e in w.events.recent() if e["op"] == "replace.copied"]
        assert len(copied) == 1 and copied[0]["quiesced"] is True
        k = copied[0]["quiesceStep"]
        assert 2 <= k < steps
        assert backend.wait("tiny-2", timeout=120) == 0, backend.log_text(
            "tiny-2")
        recs = [json.loads(line) for line in open(metrics)]
        got = [r for r in recs if "step" in r]
        assert [r["step"] for r in got] == list(range(1, steps + 1))
        assert [r["loss"] for r in got] == ref
        assert {"checkpoint": k, "quiesced": True}.items() <= next(
            r for r in recs if r.get("quiesced")).items()
        assert "resuming quiesced run" in backend.log_text("tiny-2")
        assert w.tpu.status.get(0) == "tiny"
    finally:
        backend.close()
        w.close()
