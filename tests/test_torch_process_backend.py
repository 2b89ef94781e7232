"""PyTorch port, the process backend (gpu_docker_api_tpu_torch/backend/
process.py):

- the ProcessBackend cases of tests/test_backend.py, on the port; the env
  injection case carries the card grant (CUDA_VISIBLE_DEVICES);
- the daemon's own CUDA_VISIBLE_DEVICES never reaches a container: the
  grant overrides it, and a container granted no card sees none;
- the warm pool, which used to be refused, is built and runs a job
  (tests/test_torch_warmpool.py holds it to JAX's pool);
- the memory grant holds where the kernel sets RLIMIT_DATA without
  enforcing it (as gVisor does): the watchdog kills the container, and an
  exec, over its grant, and walks /proc once a poll however many
  containers it watches;
- the ProcessBackend cases of tests/test_supervision.py: restart policies,
  their backoff and its forgiveness, the rootfs quota watchdog and the
  volume quotas; each decision is held to JAX's backend on the same
  container.
"""

import os
import resource
import signal
import sys
import time

import pytest
import torch
from conftest import wait_for

from gpu_docker_api_tpu.backend import process as jax_process_mod
from gpu_docker_api_tpu.backend.process import ProcessBackend as JaxBackend
from gpu_docker_api_tpu.dtos import ContainerSpec as JaxSpec
from gpu_docker_api_tpu_torch.backend import ProcessBackend
from gpu_docker_api_tpu_torch.backend import process as process_mod
from gpu_docker_api_tpu_torch.dtos import ContainerSpec

torch.set_num_threads(1)

MiB = 1024 * 1024


@pytest.fixture()
def backend(tmp_path):
    b = ProcessBackend(str(tmp_path / "state"))
    yield b
    b.close()


def _spec(**kw):
    d = dict(image="", cmd=["sleep", "30"], env=["FOO=bar"])
    d.update(kw)
    return ContainerSpec(**d)


def _wait(b, name, timeout=60):
    """Wait for a container's process to exit; its exit code."""
    return b.wait(name, timeout=timeout)


def test_create_start_inspect_stop(backend):
    backend.create("rs-1", _spec())
    st = backend.inspect("rs-1")
    assert st.exists and not st.running
    backend.start("rs-1")
    st = backend.inspect("rs-1")
    assert st.running and st.upper_dir and os.path.isdir(st.upper_dir)
    backend.stop("rs-1")
    assert not backend.inspect("rs-1").running
    backend.remove("rs-1")
    assert not backend.inspect("rs-1").exists


def test_duplicate_create_rejected(backend):
    backend.create("rs-1", _spec())
    with pytest.raises(RuntimeError):
        backend.create("rs-1", _spec())


def test_list_names_prefix(backend):
    for name in ("foo-1", "foo-2", "bar-1"):
        backend.create(name, _spec())
    assert backend.list_names("foo-") == ["foo-1", "foo-2"]


def test_remove_running_requires_force(backend):
    backend.create("rs-1", _spec())
    backend.start("rs-1")
    with pytest.raises(RuntimeError):
        backend.remove("rs-1", force=False)
    backend.remove("rs-1", force=True)
    assert not backend.inspect("rs-1").exists


def test_volumes(backend):
    v = backend.volume_create("vol", size_bytes=MiB)
    assert v.exists and os.path.isdir(v.mountpoint)
    with open(os.path.join(v.mountpoint, "data.bin"), "wb") as f:
        f.write(b"z" * 2048)
    assert backend.volume_inspect("vol").used_bytes == 2048
    with pytest.raises(RuntimeError):
        backend.volume_create("vol")
    backend.volume_remove("vol")
    assert not backend.volume_inspect("vol").exists


def test_exec_real_output(backend):
    backend.create("rs-1", _spec(env=["GREETING=hello"]))
    backend.start("rs-1")
    code, out = backend.execute("rs-1", ["sh", "-c", "echo $GREETING world"])
    assert code == 0 and "hello world" in out


def test_card_env_injection(backend):
    backend.create("rs-1", _spec(tpu_env={"CUDA_VISIBLE_DEVICES": "0,1",
                                          "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}))
    backend.start("rs-1")
    code, out = backend.execute(
        "rs-1", ["sh", "-c", "echo cards=$CUDA_VISIBLE_DEVICES "
                             "order=$CUDA_DEVICE_ORDER"])
    assert code == 0 and "cards=0,1 order=PCI_BUS_ID" in out


def test_daemon_visible_devices_do_not_leak(tmp_path, monkeypatch):
    """The daemon may see every card; a container sees its grant's cards,
    and none without a grant."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        b.create("granted", _spec(tpu_env={"CUDA_VISIBLE_DEVICES": "5"},
                                  env=["CUDA_VISIBLE_DEVICES=2"]))
        b.create("bare", _spec())
        for name in ("granted", "bare"):
            b.start(name)
        probe = ["sh", "-c", 'echo "cards=[${CUDA_VISIBLE_DEVICES-unset}]"']
        assert "cards=[5]" in b.execute("granted", probe)[1]
        assert "cards=[]" in b.execute("bare", probe)[1]
    finally:
        b.close()


def test_warm_pool_is_built_and_runs_a_job(tmp_path):
    """warm_pool > 0 builds a pool, and a python job runs on a worker."""
    b = ProcessBackend(str(tmp_path / "s"), warm_pool=2,
                       warm_preimport="json")
    try:
        assert b._pool is not None and b._pool.size == 2
        b.create("rs-1", _spec(cmd=[sys.executable, "-c", "print('warm')"]))
        b.start("rs-1")
        assert b.wait("rs-1", timeout=30) == 0
        assert "warm" in b.log_text("rs-1")
    finally:
        b.close()


def test_pause_continue(backend):
    backend.create("rs-1", _spec())
    backend.start("rs-1")
    backend.pause("rs-1")
    assert backend.inspect("rs-1").paused
    backend.restart_inplace("rs-1")
    st = backend.inspect("rs-1")
    assert st.running and not st.paused


def test_binds_symlinked(backend, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "weights.bin").write_bytes(b"W" * 10)
    backend.create("rs-1", _spec(binds=[f"{data}:/root/foo-tmp"]))
    backend.start("rs-1")
    code, out = backend.execute(
        "rs-1", ["sh", "-c", "cat $CONTAINER_ROOT/root/foo-tmp/weights.bin"])
    assert code == 0 and "WWWWWWWWWW" in out


def test_commit_and_seed(backend):
    backend.create("rs-1", _spec())
    backend.start("rs-1")
    backend.execute("rs-1", ["sh", "-c", "echo state > $CONTAINER_ROOT/f.txt"])
    backend.commit("rs-1", "myimage:v1")
    backend.create("rs-2", _spec(image="myimage:v1"))
    backend.start("rs-2")
    code, out = backend.execute("rs-2", ["sh", "-c", "cat $CONTAINER_ROOT/f.txt"])
    assert code == 0 and "state" in out


def test_stop_terminates(backend):
    backend.create("rs-1", _spec(cmd=["sleep", "300"]))
    backend.start("rs-1")
    assert backend.inspect("rs-1").pid is not None
    backend.stop("rs-1", timeout=30)
    st = backend.inspect("rs-1")
    # ended by the SIGTERM, not the SIGKILL escalation of a wedged stop
    assert not st.running and st.exit_code == -15
    assert backend.stop_kills == 0


def test_port_grant_env(backend):
    backend.create("rs-1", _spec(port_bindings={"8080": 40123,
                                                "10001": 40456}))
    backend.start("rs-1")
    code, out = backend.execute(
        "rs-1", ["sh", "-c",
                 "echo p=$PORT a=$HOST_PORT_8080 b=$HOST_PORT_10001"])
    assert code == 0 and "p=40123 a=40123 b=40456" in out


def test_port_env_daemon_port_does_not_leak(tmp_path, monkeypatch):
    monkeypatch.setenv("PORT", "1234")
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        b.create("rs-1", _spec(port_bindings={"8000": 40999}))
        b.start("rs-1")
        assert "p=40999" in b.execute("rs-1", ["sh", "-c", "echo p=$PORT"])[1]
        b.create("rs-2", _spec(port_bindings={"8000": 40999},
                               env=["PORT=7777"]))
        b.start("rs-2")
        assert "p=7777" in b.execute("rs-2", ["sh", "-c", "echo p=$PORT"])[1]
    finally:
        b.close()


def test_volume_quota_persisted(backend):
    v = backend.volume_create("vol", size_bytes=5 * MiB)
    with open(os.path.join(v.mountpoint, "d.bin"), "wb") as f:
        f.write(b"x" * 1024)
    got = backend.volume_inspect("vol")
    assert (got.size_limit_bytes, got.used_bytes) == (5 * MiB, 1024)
    backend.volume_remove("vol")
    assert not backend.volume_inspect("vol").exists
    backend.volume_create("vol")
    assert backend.volume_inspect("vol").size_limit_bytes == 0


def test_volume_named_like_quota_dir(backend):
    backend.volume_create("vol", size_bytes=1024)
    assert backend.volume_create(".quotas").exists
    backend.volume_remove(".quotas")
    assert backend.volume_inspect("vol").size_limit_bytes == 1024


# ---- the memory grant ------------------------------------------------------

# allocates past a 200 MiB grant and holds it, as a workload does
ALLOC = ("import time; b = bytearray(400 * 1024 * 1024); "
         "print('allocated', flush=True); time.sleep(30)")


@pytest.fixture(params=["kernel", "unenforced"])
def limit_mode(request, monkeypatch):
    """`kernel`: RLIMIT_DATA as this host enforces it (where it does not,
    the watchdog acts); `unenforced`: the limit is never set, as on a
    kernel that ignores it, so the watchdog alone must hold the grant."""
    if request.param == "unenforced":
        monkeypatch.setattr(process_mod.resource, "prlimit",
                            lambda *a, **k: None)
    return request.param


def test_memory_limit_enforced(tmp_path, limit_mode):
    """A workload allocating past its grant dies (refused by the kernel, or
    killed by the watchdog); the same workload without a limit runs."""
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        b.create("fat", _spec(cmd=[sys.executable, "-c", ALLOC],
                              memory_bytes=200 * MiB))
        b.start("fat")
        assert _wait(b, "fat") != 0
        b.create("ok", _spec(cmd=[sys.executable, "-c",
                                  ALLOC.replace("time.sleep(30)", "0")]))
        b.start("ok")
        assert _wait(b, "ok") == 0
        if limit_mode == "unenforced":
            assert b.inspect("fat").exit_code == -9
            assert b.memory_kills == 1
            assert "memory grant exceeded" in b.log_text("fat")
    finally:
        b.close()


def test_exec_shares_memory_limit(tmp_path, limit_mode):
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        b.create("rs-1", _spec(memory_bytes=200 * MiB))
        b.start("rs-1")
        code, out = b.execute("rs-1", [sys.executable, "-c",
                                       ALLOC.replace("allocated", "survived")
                                       .replace("time.sleep(30)",
                                                "time.sleep(30); print('end')")])
        assert code != 0 and "end" not in out
        assert b.inspect("rs-1").running     # the exec died, not the container
    finally:
        b.close()


def test_memory_watchdog_spares_a_process_within_its_grant(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(process_mod.resource, "prlimit", lambda *a, **k: None)
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        small = ("import time; b = bytearray(20 * 1024 * 1024); "
                 "time.sleep(0.5); print('fine', flush=True)")
        b.create("thin", _spec(cmd=[sys.executable, "-c", small],
                               memory_bytes=400 * MiB))
        b.start("thin")
        assert _wait(b, "thin") == 0 and b.memory_kills == 0
    finally:
        b.close()


def test_rlimit_is_set_on_the_child(tmp_path):
    """The first level: the child carries RLIMIT_DATA = its grant."""
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        b.create("rs-1", _spec(memory_bytes=300 * MiB))
        b.start("rs-1")
        pid = b.inspect("rs-1").pid
        assert resource.prlimit(pid, resource.RLIMIT_DATA) == (300 * MiB,) * 2
    finally:
        b.close()


# ---- the spec and the size helpers: JAX's -----------------------------------

def test_container_spec_is_the_jax_record():
    """The stored spec has JAX's fields and defaults, and a spec written by
    either package reads in the other (tpu_env / devices carry the card
    grant)."""
    from gpu_docker_api_tpu.dtos import ContainerSpec as JSpec
    assert ContainerSpec().to_json() == JSpec().to_json()
    spec = ContainerSpec(cmd=["python", "-m", "x"], tpu_chips=[0, 1],
                         tpu_env={"CUDA_VISIBLE_DEVICES": "0,1"},
                         devices=["/dev/nvidia3", "/dev/nvidia0"],
                         memory_bytes=8 << 30, mesh_plan={"dp": 2})
    assert JSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    assert ContainerSpec.from_json(JSpec.from_json(spec.to_json()).to_json()) \
        == spec


@pytest.mark.parametrize("size", ["30GB", "1.5MB", "7kb", " 2TB ", "x",
                                  "10", "GB", "abcGB"])
def test_to_bytes_is_the_jax_one(size):
    from gpu_docker_api_tpu.utils.file import to_bytes as jax_to_bytes
    from gpu_docker_api_tpu_torch.utils.file import to_bytes
    try:
        want = jax_to_bytes(size)
    except ValueError:
        with pytest.raises(ValueError):
            to_bytes(size)
        return
    assert to_bytes(size) == want


def test_dir_size_counts_hardlinks_once(tmp_path):
    from gpu_docker_api_tpu.utils.file import dir_size as jax_dir_size
    from gpu_docker_api_tpu_torch.utils.file import dir_size
    (tmp_path / "a").write_bytes(b"x" * 100)
    os.link(tmp_path / "a", tmp_path / "b")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c").write_bytes(b"y" * 7)
    os.symlink(tmp_path / "a", tmp_path / "link")
    assert dir_size(str(tmp_path)) == jax_dir_size(str(tmp_path)) == 107


# ---- the memory watchdog's load ---------------------------------------------

def test_memory_watchdog_walks_proc_once_a_poll(tmp_path, monkeypatch):
    """However many containers it watches, a poll walks /proc once; with
    none watched it walks nothing."""
    walks = []
    real = process_mod._process_groups
    monkeypatch.setattr(process_mod, "_process_groups",
                        lambda: walks.append(1) or real())
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        names = [f"rs-{i}" for i in range(4)]
        for name in names:
            b.create(name, _spec(memory_bytes=400 * MiB))
            b.start(name)
        polls, walked = b.memory_polls, len(walks)
        wait_for(lambda: b.memory_polls >= polls + 10, msg="10 polls")
        assert abs((len(walks) - walked) - (b.memory_polls - polls)) <= 1
        assert all(b.inspect(n).running for n in names)
        assert b.memory_kills == 0 and b.memory_watch_cpu_s > 0
        for name in names:
            b.stop(name)
        polls, walked = b.memory_polls, len(walks)
        wait_for(lambda: b.memory_polls >= polls + 5, msg="5 idle polls")
        assert len(walks) <= walked + 1       # a poll may have been under way
    finally:
        b.close()


def test_memory_watchdog_kills_only_the_group_over_its_grant(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(process_mod.resource, "prlimit", lambda *a, **k: None)
    b = ProcessBackend(str(tmp_path / "s"))
    try:
        for name in ("thin-1", "thin-2"):
            b.create(name, _spec(memory_bytes=400 * MiB))
            b.start(name)
        b.create("fat", _spec(cmd=[sys.executable, "-c", ALLOC],
                              memory_bytes=200 * MiB))
        b.start("fat")
        assert _wait(b, "fat") == -9
        assert b.memory_kills == 1
        assert b.inspect("thin-1").running and b.inspect("thin-2").running
    finally:
        b.close()


# ---- supervision: restart policies, backoff, the rootfs quota ----------------
# The ProcessBackend cases of tests/test_supervision.py. Each policy and
# timing decision runs on both packages' backends, driven one supervisor
# tick at a time (no supervisor thread, a fixed clock where the decision
# reads one); the thread-driven cases wait on their condition with a
# timeout.

BACKENDS = {"port": (ProcessBackend, ContainerSpec),
            "jax": (JaxBackend, JaxSpec)}


def _runs(b, name):
    path = os.path.join(b.inspect(name).upper_dir, "runs.txt")
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return len(f.read().splitlines())


def _log(b, name):
    with open(b._get(name).log_path) as f:     # JAX's backend has no log_text
        return f.read()


@pytest.fixture()
def sup(tmp_path):
    b = ProcessBackend(str(tmp_path / "b"), supervise=True,
                       supervise_interval=0.05)
    yield b
    b.close()


def _sup_start(b, name, shell, policy="unless-stopped", quota="30G"):
    b.create(name, ContainerSpec(cmd=["sh", "-c", shell],
                                 restart_policy=policy, rootfs_quota=quota))
    b.start(name)
    return b.inspect(name)


def _policy_outcome(kind, root, policy, shell, stopped):
    """One container's exit, then two supervisor ticks (the first observes
    the exit, the second finds its restart due): whether it restarted."""
    backend_cls, spec_cls = BACKENDS[kind]
    b = backend_cls(root)
    try:
        b.create("c", spec_cls(cmd=["sh", "-c",
                                    f"echo run >> runs.txt; {shell}"],
                               restart_policy=policy))
        b.start("c")
        p = b._get("c")
        first = p.popen
        if stopped:
            wait_for(lambda: _runs(b, "c") >= 1, msg="the first run")
            b.stop("c", timeout=10)
        else:
            first.wait(timeout=30)
        b._supervise_one("c", p)
        scheduled = bool(p.restart_at)
        if scheduled:
            p.restart_at = time.time() - 1
        b._supervise_one("c", p)
        restarted = p.popen is not first
        if restarted:
            p.popen.wait(timeout=30)
        return {"scheduled": scheduled, "restarted": restarted,
                "restart_count": p.restart_count, "runs": _runs(b, "c"),
                "logged": "supervisor: restarting" in _log(b, "c")}
    finally:
        b.close()


@pytest.mark.parametrize("policy,shell,stopped,restarts", [
    ("unless-stopped", "exit 0", False, True),   # even a clean exit
    ("unless-stopped", "exit 1", False, True),
    ("always", "exit 0", False, True),
    ("on-failure", "exit 3", False, True),
    ("on-failure", "exit 0", False, False),      # rc 0: no restart
    ("no", "exit 1", False, False),
    ("", "exit 1", False, False),
    ("bogus", "exit 1", False, False),
    ("unless-stopped", "sleep 60", True, False),  # an explicit stop is final
])
def test_restart_policy_matches_jax(tmp_path, policy, shell, stopped,
                                    restarts):
    got = {kind: _policy_outcome(kind, str(tmp_path / kind), policy, shell,
                                 stopped) for kind in BACKENDS}
    assert got["port"] == got["jax"]
    assert got["port"]["restarted"] is restarts
    assert got["port"]["runs"] == (2 if restarts else 1)
    assert got["port"]["logged"] is restarts


class _FixedClock:
    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now


def _tick_at(kind, root, monkeypatch, now, prepare):
    """One supervisor tick under a fixed clock, after `prepare(p)`; the
    proc's (restart_at - now, restart_count)."""
    backend_cls, spec_cls = BACKENDS[kind]
    mod = process_mod if kind == "port" else jax_process_mod
    b = backend_cls(root)
    try:
        b.create("c", spec_cls(cmd=["sh", "-c", prepare["shell"]],
                               restart_policy="always"))
        b.start("c")
        p = b._get("c")
        if prepare.get("exited"):
            p.popen.wait(timeout=30)
        p.restart_count = prepare["count"]
        p.started_at = now - prepare.get("healthy_for", 0.0)
        with monkeypatch.context() as m:
            m.setattr(mod, "time", _FixedClock(now))
            b._supervise_one("c", p)
        return (p.restart_at - now if p.restart_at else None,
                p.restart_count)
    finally:
        b.close()


@pytest.mark.parametrize("count", [0, 1, 2, 5, 7, 8, 12])
def test_restart_backoff_matches_jax(tmp_path, monkeypatch, count):
    """The delay before a restart doubles with each one, from 0.25 s up
    to 30 s."""
    prep = {"shell": "exit 1", "exited": True, "count": count}
    got = {kind: _tick_at(kind, str(tmp_path / kind), monkeypatch, 1000.0,
                          prep) for kind in BACKENDS}
    assert got["port"] == got["jax"]
    assert got["port"] == (min(30.0, 0.25 * 2 ** min(count, 7)), count)


@pytest.mark.parametrize("healthy_for,forgiven", [(10.5, True),
                                                  (9.5, False)])
def test_backoff_forgiveness_matches_jax(tmp_path, monkeypatch, healthy_for,
                                         forgiven):
    """A container healthy past forgive_after (10 s) has its restart
    history forgiven, so a later crash restarts promptly."""
    prep = {"shell": "sleep 60", "count": 3, "healthy_for": healthy_for}
    got = {kind: _tick_at(kind, str(tmp_path / kind), monkeypatch, 1000.0,
                          prep) for kind in BACKENDS}
    assert got["port"] == got["jax"] == (None, 0 if forgiven else 3)


def test_crashed_container_is_restarted(sup):
    st = _sup_start(sup, "c1", "echo run >> runs.txt; sleep 60")
    wait_for(lambda: _runs(sup, "c1") >= 1, msg="first run")
    os.kill(st.pid, signal.SIGKILL)                 # a crash
    wait_for(lambda: _runs(sup, "c1") >= 2, msg="supervised restart")
    st2 = sup.inspect("c1")
    assert st2.running and st2.pid != st.pid
    assert "supervisor: restarting" in sup.log_text("c1")


def test_exited_container_restarts_under_unless_stopped(sup):
    _sup_start(sup, "c2", "echo run >> runs.txt; exit 0")
    wait_for(lambda: _runs(sup, "c2") >= 2, msg="restart after exit 0")


def test_rootfs_quota_watchdog_kills_writer(sup):
    st = _sup_start(sup, "c7", "dd if=/dev/zero of=big bs=1M count=5 "
                               "2>/dev/null; sleep 60", quota="1MB")
    assert st.running
    wait_for(lambda: not sup.inspect("c7").running, timeout=15,
             msg="quota kill")
    assert "storage quota exceeded" in sup.log_text("c7")
    # the kill is final: the restart policy must not bring back a workload
    # that would breach again at once
    assert sup._get("c7").quota_exceeded


@pytest.mark.parametrize("quota,killed", [("1MB", True), ("30G", False),
                                          ("", False)])
def test_rootfs_quota_matches_jax(tmp_path, quota, killed):
    """One quota check on a rootfs holding 5 MiB, then two supervisor
    ticks: a breach kills the container for good."""
    got = {}
    for kind, (backend_cls, spec_cls) in BACKENDS.items():
        b = backend_cls(str(tmp_path / kind))
        try:
            b.create("c", spec_cls(
                cmd=["sh", "-c", "dd if=/dev/zero of=big bs=1M count=5 "
                                 "2>/dev/null; touch done; sleep 60"],
                restart_policy="always", rootfs_quota=quota))
            b.start("c")
            done = os.path.join(b.inspect("c").upper_dir, "done")
            wait_for(lambda: os.path.exists(done), msg="the write")
            p = b._get("c")
            b._enforce_rootfs_quota("c", p, time.time())
            for _ in range(2):
                b._supervise_one("c", p)
                if p.restart_at:
                    p.restart_at = time.time() - 1
            got[kind] = (b.inspect("c").running, p.quota_exceeded,
                         p.restart_count,
                         "storage quota exceeded" in _log(b, "c"))
        finally:
            b.close()
    assert got["port"] == got["jax"] == (not killed, killed, 0, killed)


class _RacingProcs(dict):
    """remove() winning the race inside _supervise_one's locked re-check:
    the lookup succeeds but the proc's popen is already None."""

    def get(self, key, default=None):
        p = super().get(key, default)
        if p is not None:
            p.popen = None
        return p


def test_supervise_remove_race_guarded(tmp_path):
    """Inside the locked re-check a concurrent remove() may have nulled
    p.popen: the tick must neither raise nor restart."""
    b = ProcessBackend(str(tmp_path / "b"))
    try:
        b.create("c1", ContainerSpec(cmd=["sh", "-c", "exit 1"],
                                     restart_policy="always"))
        b.start("c1")
        p = b._get("c1")
        b.wait("c1", timeout=10)
        b._supervise_one("c1", p)                # observes the death
        assert p.restart_at > 0
        p.restart_at = time.time() - 1           # the restart is due now
        b._procs = _RacingProcs(b._procs)        # remove() races the lock
        b._supervise_one("c1", p)
        assert p.popen is None
        assert p.restart_count == 0
    finally:
        b.close()


def test_remove_nulls_popen_for_stale_handles(tmp_path):
    b = ProcessBackend(str(tmp_path / "b"))
    try:
        b.create("c1", ContainerSpec(cmd=["sleep", "30"]))
        b.start("c1")
        p = b._get("c1")
        b.remove("c1", force=True)
        assert p.popen is None
        b._supervise_one("c1", p)                # a stale tick: a no-op
    finally:
        b.close()


@pytest.mark.parametrize("quota", ["30G", "30GB", "512MB", "1T", "7K", "",
                                   "garbage", " 2g "])
def test_quota_bytes_matches_jax(quota):
    assert process_mod._quota_bytes(quota) == \
        jax_process_mod._quota_bytes(quota)
    assert process_mod._quota_bytes("30G") == 30 * 1024 ** 3


# ---- volume quota: loopback ENOSPC, or the advisory fallback ----------------

def test_volume_quota_enospc(tmp_path):
    b = ProcessBackend(str(tmp_path / "b"))
    try:
        if not b._loopfs_capable():
            pytest.skip("host can't loop-mount (no CAP_SYS_ADMIN)")
        vs = b.volume_create("q1", size_bytes=16 << 20)
        assert vs.driver_opts["enforced"] is True
        assert os.path.ismount(vs.mountpoint)
        with pytest.raises(OSError) as ei:
            with open(os.path.join(vs.mountpoint, "big"), "wb") as f:
                chunk = b"\0" * (1 << 20)
                for _ in range(32):
                    f.write(chunk)
                    f.flush()
                    os.fsync(f.fileno())
        assert ei.value.errno == 28                 # ENOSPC
        st = b.volume_inspect("q1")
        assert st.size_limit_bytes == 16 << 20 and st.used_bytes > 0
        b.volume_remove("q1")
        assert not os.path.exists(vs.mountpoint)
        assert not os.path.exists(os.path.join(b._volimg_dir, "q1.img"))
    finally:
        b.close()


def test_volume_quota_fallback_is_advisory(tmp_path):
    """Where the host can't mount, a sized volume stays a plain dir and its
    quota is advisory: the write succeeds, inspect reports the limit."""
    b = ProcessBackend(str(tmp_path / "b"))
    try:
        b._loopfs = False                           # force the fallback
        vs = b.volume_create("q2", size_bytes=8 << 20)
        assert vs.driver_opts["enforced"] is False
        assert not os.path.ismount(vs.mountpoint)
        with open(os.path.join(vs.mountpoint, "big"), "wb") as f:
            f.write(b"\0" * (12 << 20))
        st = b.volume_inspect("q2")
        assert st.size_limit_bytes == 8 << 20
        assert st.used_bytes >= 12 << 20
    finally:
        b.close()


def test_close_releases_and_restart_remounts(tmp_path):
    b = ProcessBackend(str(tmp_path / "b"))
    if not b._loopfs_capable():
        b.close()
        pytest.skip("host can't loop-mount")
    vs = b.volume_create("q3", size_bytes=16 << 20)
    assert os.path.ismount(vs.mountpoint)
    with open(os.path.join(vs.mountpoint, "ckpt"), "w") as f:
        f.write("step-42")
    b.close()
    assert not os.path.ismount(vs.mountpoint)
    assert os.path.exists(os.path.join(b._volimg_dir, "q3.img"))
    # a new backend on the same state dir remounts: the data is back, and
    # the quota is still the kernel's
    b2 = ProcessBackend(str(tmp_path / "b"))
    try:
        assert os.path.ismount(vs.mountpoint)
        with open(os.path.join(vs.mountpoint, "ckpt")) as f:
            assert f.read() == "step-42"
    finally:
        b2.close()


def test_volume_quota_below_loopfs_floor_stays_advisory(tmp_path):
    """A quota smaller than ext4 can enforce is not reported as enforced
    at a wrong limit."""
    b = ProcessBackend(str(tmp_path / "b"))
    try:
        vs = b.volume_create("q4", size_bytes=1 << 20)
        assert vs.driver_opts["enforced"] is False
        assert not os.path.ismount(vs.mountpoint)
        assert b.volume_inspect("q4").size_limit_bytes == 1 << 20
    finally:
        b.close()
