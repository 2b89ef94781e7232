"""PyTorch port, the guarded backend and the transient faults
(gpu_docker_api_tpu_torch/backend/guard.py, faults.py) against JAX's, at
the library level of tests/test_substrate_faults.py.

Each case runs on both packages' services (tests/test_torch_services.py's
World, with the same normalisation) over GuardedBackend(MockBackend) at
that file's scale (deadline 0.4 s, 2 retries, hang 1.2 s), with each
package's own faults armed: the transient-fault sweep (every mutating
service call x every backend op it crosses x error_once, error_n:4,
latency:0.02, hang:1.2), error_n exhausting then recovering, the breaker
opening and recovering through its half-open probe (and reopening when
the probe fails), degraded reads under an open breaker, the cordon and
drain cases, and TDAPI_FAULTS. The record of each package (every call's
outcome, observations, then the store and the events) must be equal, and
each must leave no leaked grant: the schedulers hold exactly the grants of
the stored records that are not released, and no intent is open. The
HTTP envelopes, the health monitor and the reconciler's crash replay of
that file belong to modules not ported yet.
"""

import pytest
import torch

from gpu_docker_api_tpu import faults as jfaults
from gpu_docker_api_tpu.backend import GuardedBackend as JGuarded
from gpu_docker_api_tpu.backend import MockBackend as JMock
from gpu_docker_api_tpu.backend.guard import NON_IDEMPOTENT as J_NON_IDEM
from gpu_docker_api_tpu.dtos import StoredContainerInfo as JInfo
from gpu_docker_api_tpu_torch import faults as tfaults
from gpu_docker_api_tpu_torch.backend import GuardedBackend as TGuarded
from gpu_docker_api_tpu_torch.backend import MockBackend as TMock
from gpu_docker_api_tpu_torch.backend.guard import CLOSED, NON_IDEMPOTENT, OPEN
from gpu_docker_api_tpu_torch.dtos import StoredContainerInfo as TInfo
from test_torch_services import World

torch.set_num_threads(1)

DEADLINE = 0.4
RETRIES = 2
HANG = 1.2        # > DEADLINE: the first attempt is cut by the deadline
MODES = ["error_once", f"error_n:{RETRIES + 2}", "latency:0.02",
         f"hang:{HANG}"]


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.disarm_faults()
    tfaults.disarm_faults()
    yield
    jfaults.disarm_faults()
    tfaults.disarm_faults()


def make(pkg, tmp_path, threshold=50, cooldown=30.0):
    jax = pkg == "jax"
    guard, mock = (JGuarded, JMock) if jax else (TGuarded, TMock)
    backend = guard(mock(str(tmp_path / f"{pkg}-backend")),
                    deadline=DEADLINE, retries=RETRIES, backoff_base=0.01,
                    backoff_cap=0.05, breaker_threshold=threshold,
                    breaker_cooldown=cooldown)
    w = World(pkg, tmp_path, port_range=(46000, 46100), backend=backend)
    w.faults = jfaults if jax else tfaults
    backend.breaker.events = w.events
    return w


def demo(w, name="demo", tpus=2, env=()):
    return w.call(f"run {name}", w.rs.run_container, w.d.ContainerRun(
        imageName="img", replicaSetName=name, tpuCount=tpus, cpuCount=2,
        containerPorts=["8888"], env=list(env)))


def no_leaks(w):
    """The schedulers hold exactly the grants of the stored records that
    are not released; no intent is open. Returns the stored records."""
    assert w.wq.join(timeout=30)
    info = JInfo if w.jax else TInfo
    stored = {kv.key.rsplit("/", 1)[1]: info.deserialize(kv.value)
              for kv in w.client.range("containers")}
    cards, cores, ports = {}, {}, {}
    for name, rec in stored.items():
        if rec.resourcesReleased:
            continue
        cards.update(dict.fromkeys(rec.spec.tpu_chips, name))
        cores.update(dict.fromkeys(w.cpu._cores(rec.spec.cpuset), name))
        ports.update(dict.fromkeys(
            (int(p) for p in rec.spec.port_bindings.values()), name))
    assert {i: o for i, o in w.tpu.status.items() if o} == cards
    assert {i: o for i, o in w.cpu.status.items() if o} == cores
    assert dict(w.ports.used) == ports
    assert w.rs.intents.open_intents() == []
    return stored


# ---- the sweep: mutations x the backend ops they cross -----------------------

def mut_run(w):
    demo(w, name="fresh")


def mut_patch(w):
    w.tpu_patch("demo", 4)


def mut_rollback(w):
    w.tpu_patch("demo", 4)
    w.call("rollback", w.rs.rollback_container, "demo", 1)


def mut_stop(w):
    w.call("stop", w.rs.stop_container, "demo")


def mut_restart(w):
    w.call("restart", w.rs.restart_container, "demo")


def mut_pause(w):
    w.call("pause", w.rs.pause_container, "demo")


def mut_continue(w):
    w.call("continue", w.rs.startup_container, "demo")


def mut_delete(w):
    w.call("delete", w.rs.delete_container, "demo")


def mut_vol_create(w):
    w.call("vol", w.vol.create_volume, "vol", "16MB")


def mut_vol_patch(w):
    w.call("vol", w.vol.create_volume, "vol", "16MB")
    w.call("vol grow", w.vol.patch_volume_size, "vol", "32MB")


def mut_vol_delete(w):
    w.call("vol", w.vol.create_volume, "vol", "16MB")
    w.call("vol delete", w.vol.delete_volume, "vol")


def mut_patch_quiesce(w):
    demo(w, env=["TDAPI_QUIESCE=1"])
    w.tpu_patch("demo", 4)


SWEEP = [
    ("run", mut_run, "create", False),
    ("run", mut_run, "start", False),
    ("patch", mut_patch, "create", False),
    ("patch", mut_patch, "start", False),
    ("patch", mut_patch, "stop", False),
    ("patch", mut_patch, "remove", True),
    ("rollback", mut_rollback, "stop", False),
    ("stop", mut_stop, "stop", False),
    ("restart", mut_restart, "create", False),
    ("restart", mut_restart, "start", False),
    ("pause", mut_pause, "pause", False),
    ("continue", mut_continue, "restart_inplace", False),
    ("delete", mut_delete, "remove", False),
    ("patchq", mut_patch_quiesce, "quiesce", True),
    ("vol.create", mut_vol_create, "volume_create", False),
    ("vol.patch", mut_vol_patch, "volume_create", False),
    ("vol.delete", mut_vol_delete, "volume_remove", True),
]


def test_non_idempotent_ops_are_jax_s():
    assert NON_IDEMPOTENT == J_NON_IDEM


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("endpoint,mutate,op,swallowed", SWEEP,
                         ids=[f"{e}-{o}" for e, _, o, _ in SWEEP])
def test_transient_fault_sweep_equals_jax(endpoint, mutate, op, swallowed,
                                          mode, tmp_path):
    """Under every fault mode every mutation converges (a bounded retry
    wins) or fails clean with nothing leaked, and its outcome is JAX's."""
    records = []
    for pkg in ("jax", "port"):
        w = make(pkg, tmp_path)
        try:
            if endpoint not in ("run", "patchq", "vol.create", "vol.patch",
                                "vol.delete"):
                demo(w)
            before = len(w.record)
            w.faults.arm_fault(f"{op}:{mode}")
            try:
                mutate(w)
            finally:
                w.faults.disarm_faults()
            failed = [r for r in w.record[before:] if r[1] == "error"]
            mode_name = mode.partition(":")[0]
            if mode_name == "hang" and op in NON_IDEMPOTENT:
                assert failed, f"{pkg} {endpoint}/{op}/{mode} passed"
            elif mode_name in ("error_once", "latency", "hang"):
                assert not failed, f"{pkg} {endpoint}/{op}/{mode}: {failed}"
            elif not swallowed:
                assert failed, f"{pkg} {endpoint}/{op}/{mode} passed"
            no_leaks(w)
            records.append(w.finish())
        finally:
            w.close()
    assert records[1] == records[0]


def test_error_n_exhausts_then_recovers_equals_jax(tmp_path):
    records = []
    for pkg in ("jax", "port"):
        w = make(pkg, tmp_path)
        try:
            w.faults.arm_fault(f"create:error_n:{RETRIES + 2}")
            demo(w)
            w.faults.disarm_faults()
            no_leaks(w)
            demo(w)
            no_leaks(w)
            records.append(w.finish())
        finally:
            w.close()
    assert records[1] == records[0]
    assert records[1][0][1:] == ("error", "InjectedFault")
    assert records[1][1][2]["name"] == "demo-1"


def breaker_cycle(w):
    """Two post-retry failures open a threshold-2 breaker; an open breaker
    refuses fast; after the cooldown the probe closes it."""
    import time
    b = w.backend
    for i in range(2):
        w.faults.arm_fault(f"inspect:error_n:{RETRIES + 1}")
        w.call(f"inspect {i}", b.inspect, "ghost")
        w.faults.disarm_faults()
    w.note("state", b.breaker.describe()["state"])
    w.call("refused", b.inspect, "ghost")
    time.sleep(0.2)
    w.call("probe", lambda: b.inspect("ghost").exists)
    w.note("state", b.breaker.describe()["state"])


def breaker_halfopen_failure_reopens(w):
    import time
    b = w.backend
    w.faults.arm_fault(f"inspect:error_n:{2 * (RETRIES + 1)}")
    w.call("inspect", b.inspect, "ghost")
    w.note("state", b.breaker.describe()["state"])
    time.sleep(0.15)
    w.call("trial", b.inspect, "ghost")
    w.note("state", b.breaker.describe()["state"])
    w.faults.disarm_faults()
    time.sleep(0.15)
    w.call("probe", lambda: b.inspect("ghost").exists)
    w.note("state", b.breaker.describe()["state"])


def breaker_open_degraded_reads(w):
    """An open breaker refuses every mutation with BackendUnavailable while
    info and history answer from the store (info degraded)."""
    w.call("vol", w.vol.create_volume, "vol", "16MB")
    demo(w)
    out = w.tpu_patch("demo", 4)
    w.tpu.cordon([out["tpuChips"][0]])
    w.backend.breaker.force_open(cooldown=60)
    for label, fn in (
            ("run", lambda: demo(w, name="x")),
            ("patch", lambda: w.tpu_patch("demo", 2)),
            ("rollback", lambda: w.rs.rollback_container("demo", 1)),
            ("stop", lambda: w.rs.stop_container("demo")),
            ("restart", lambda: w.rs.restart_container("demo")),
            ("pause", lambda: w.rs.pause_container("demo")),
            ("continue", lambda: w.rs.startup_container("demo")),
            ("execute", lambda: w.rs.execute_container("demo", ["ls"])),
            ("commit", lambda: w.rs.commit_container("demo", "img2")),
            ("delete", lambda: w.rs.delete_container("demo")),
            ("vol create", lambda: w.vol.create_volume("v", "16MB")),
            ("vol grow", lambda: w.vol.patch_volume_size("vol", "32MB")),
            ("vol delete", lambda: w.vol.delete_volume("vol")),
            ("drain", w.rs.drain_cordoned)):
        w.call(label, fn)
    w.call("info", w.rs.get_container_info, "demo")
    w.call("history", lambda: [h["version"] for h in
                               w.rs.get_container_history("demo")])
    w.call("vol info", w.vol.get_volume_info, "vol")
    w.note("free", w.tpu.get_status()["freeCount"])
    w.backend.breaker.force_close()


def cordon_drain_end_to_end(w):
    out = demo(w, tpus=4)
    victim = out["tpuChips"][0]
    w.call("cordon", w.tpu.cordon, [victim])
    w.call("drain", w.rs.drain_cordoned)
    w.note("sched", w.sched())
    w.note("cordoned", sorted(w.tpu.cordoned_snapshot()))
    w.call("history", w.rs.get_container_history, "demo")
    w.call("uncordon", w.tpu.uncordon, [victim])


def drain_insufficient_capacity_fails_clean(w):
    demo(w, tpus=16)
    w.tpu.cordon([0])
    w.call("drain", w.rs.drain_cordoned)
    w.call("info", w.rs.get_container_info, "demo")


def drain_skips_stopped_replicasets(w):
    out = demo(w)
    w.call("stop", w.rs.stop_container, "demo")
    w.tpu.cordon([out["tpuChips"][0]])
    w.call("drain", w.rs.drain_cordoned)


def drain_repost_after_partial_failure(w):
    a, b = demo(w, name="aaa"), demo(w, name="bbb")
    w.tpu.cordon(sorted({a["tpuChips"][0], b["tpuChips"][0]}))
    w.faults.arm_fault(f"create:error_n:{RETRIES + 1}")
    w.call("drain 1", w.rs.drain_cordoned)
    w.faults.disarm_faults()
    no_leaks(w)
    w.call("drain 2", w.rs.drain_cordoned)
    w.call("drain 3", w.rs.drain_cordoned)


def fault_gate_env_var(w, monkeypatch=None):
    import os
    os.environ[w.faults.FAULTS_ENV_VAR] = f"create:error_n:{RETRIES + 2}"
    try:
        demo(w)
    finally:
        del os.environ[w.faults.FAULTS_ENV_VAR]
        w.faults.disarm_faults()
    demo(w, name="after")


LIBRARY_CASES = {
    "breaker_cycle": (breaker_cycle, dict(threshold=2, cooldown=0.15)),
    "breaker_halfopen_failure_reopens": (breaker_halfopen_failure_reopens,
                                         dict(threshold=1, cooldown=0.1)),
    "breaker_open_degraded_reads": (breaker_open_degraded_reads, {}),
    "cordon_drain_end_to_end": (cordon_drain_end_to_end, {}),
    "drain_insufficient_capacity_fails_clean": (
        drain_insufficient_capacity_fails_clean, {}),
    "drain_skips_stopped_replicasets": (drain_skips_stopped_replicasets, {}),
    "drain_repost_after_partial_failure": (drain_repost_after_partial_failure,
                                           {}),
    "fault_gate_env_var": (fault_gate_env_var, {}),
}


@pytest.mark.parametrize("name", sorted(LIBRARY_CASES))
def test_guard_case_equals_jax(tmp_path, name):
    case, kw = LIBRARY_CASES[name]
    records = []
    for pkg in ("jax", "port"):
        w = make(pkg, tmp_path, **kw)
        try:
            case(w)
            no_leaks(w)
            records.append(w.finish())
        finally:
            w.close()
    assert records[1] == records[0]


def test_breaker_states_and_events(tmp_path):
    """The port's breaker alone: the states the cycle passes through and
    the transitions it writes to the event log."""
    w = make("port", tmp_path, threshold=2, cooldown=0.15)
    try:
        breaker_cycle(w)
        states = [r[2] for r in w.record if r[0] == "state"]
        assert states == [OPEN, CLOSED]
        assert [r[1:] for r in w.record if r[0] == "refused"] == [
            ("error", "BackendUnavailableError")]
        ops = [e["op"] for e in w.events.recent()]
        assert "breaker.open" in ops and "breaker.closed" in ops
    finally:
        w.close()
