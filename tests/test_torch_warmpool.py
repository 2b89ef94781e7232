"""PyTorch port, the warm worker pool (gpu_docker_api_tpu_torch/backend/
warmpool.py) and its use by the process backend, against JAX's.

- Every case of tests/test_warmpool.py but the jax re-pointing one runs on
  both packages' ProcessBackend and WarmPool (preimport "json", as there):
  the warm start in a pool worker, stop and exit codes, the refill, the
  dead worker's cold fallback, PYTHONPATH and non-python commands
  bypassing the pool, the give-up streak and the reap at close. What each
  run observes (warm or cold, the job's cwd, argv, env and stdin, exit
  codes, pool stats) must be equal between the packages; pids and
  directories are compared by role, not by value.
- supports() classifies every command and env as JAX's does, but for the
  import-baked variables: JAX refuses JAX_DEFAULT_DTYPE_BITS and re-points
  other JAX_* through jax.config; the port refuses OMP_NUM_THREADS,
  MKL_NUM_THREADS and TORCH_LOGS (which a probe shows `import torch` fixes)
  and takes JAX_* and the card variables as any other env.
- A torch worker (preimport "torch") leaves CUDA uninitialised, so a job
  it runs sees its own grant (CUDA_VISIBLE_DEVICES); a worker whose
  preimport initialised CUDA never runs a job in its interpreter: it execs
  the job's command, a cold start in the same process, and says so in the
  log. That holds too when the preimport initialised only the driver
  (`torch.cuda.is_available()`), which the worker asks the driver about;
  with no driver on this host, a file mapped under its name stands in,
  with a fixed answer. Workers see every card of the node. The workers'
  own env (here a PYTHONPATH) reaches their imports.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import wait_for
from gpu_docker_api_tpu.backend import warmpool as jwarm
from gpu_docker_api_tpu.backend.process import ProcessBackend as JBackend
from gpu_docker_api_tpu.dtos import ContainerSpec as JSpec
from gpu_docker_api_tpu_torch.backend import warmpool as twarm
from gpu_docker_api_tpu_torch.backend.process import ProcessBackend as TBackend
from gpu_docker_api_tpu_torch.dtos import ContainerSpec as TSpec

torch.set_num_threads(1)

SIDES = {"jax": (JBackend, jwarm, JSpec), "port": (TBackend, twarm, TSpec)}


class Side:
    def __init__(self, pkg, tmp_path):
        self.Backend, self.warm, self.Spec = SIDES[pkg]
        self.root = tmp_path / pkg
        self.root.mkdir()
        self.record = []

    def backend(self, size=1, preimport="json"):
        return self.Backend(str(self.root / f"b{size}"), warm_pool=size,
                            warm_preimport=preimport)

    def run(self, b, name, code, env=None):
        b.create(name, self.Spec(image="", cmd=[sys.executable, "-c", code],
                                 env=env or []))
        b.start(name)
        return b.inspect(name)

    def note(self, label, value):
        self.record.append((label, value))


def marker(st, name="marker.json"):
    path = os.path.join(st.upper_dir, name)
    rec = {}

    def parsed():
        nonlocal rec
        try:
            rec = json.loads(open(path).read())
            return True
        except (OSError, ValueError):
            return False
    wait_for(parsed, msg=name)
    return rec


PROBE = ("import os, sys, json\n"
         "rec = {'pid': os.getpid(), 'cwd': os.getcwd(), 'argv': sys.argv,\n"
         "       'foo': os.environ.get('FOO'),\n"
         "       'root': os.environ.get('CONTAINER_ROOT'),\n"
         "       'stdin': sys.stdin.read(), 'json_warm': 'json' in "
         "sys.modules}\n"
         "open('marker.json', 'w').write(json.dumps(rec))\n"
         "print('hello-from-warm')\n")


def warm_start_runs_in_pool_worker(s):
    b = s.backend()
    try:
        pool_pids = {w.pid for w in b._pool._idle}
        st = s.run(b, "c1", PROBE, env=["FOO=bar"])
        rec = marker(st)
        s.note("warm", rec["pid"] in pool_pids)
        s.note("cwd", os.path.realpath(rec["cwd"])
               == os.path.realpath(st.upper_dir))
        s.note("root", rec["root"] == st.upper_dir)
        s.note("job", [rec["argv"], rec["foo"], rec["stdin"],
                       rec["json_warm"]])
        log = b._get("c1").log_path
        wait_for(lambda: os.path.exists(log) and "hello-from-warm"
                 in open(log).read(), msg="log")
    finally:
        b.close()


def warm_worker_is_stoppable_and_exit_code_seen(s):
    b = s.backend()
    try:
        s.note("running", s.run(b, "c2", "import time\ntime.sleep(60)\n")
               .running)
        b.stop("c2", timeout=5)
        s.note("stopped", b.inspect("c2").running)
        s.run(b, "c3", "import sys\nsys.exit(7)\n")
        wait_for(lambda: not b.inspect("c3").running, msg="c3 exit")
        s.note("exit", b.inspect("c3").exit_code)
    finally:
        b.close()


def pool_refills_after_take(s):
    b = s.backend()
    try:
        s.run(b, "c4", "pass")
        wait_for(lambda: len(b._pool._idle) >= 1, msg="pool refill")
        s.note("stats", b._pool.stats())
    finally:
        b.close()


def dead_worker_falls_back_to_cold_spawn(s):
    b = s.backend()
    try:
        wait_for(lambda: len(b._pool._idle) >= 1, msg="initial worker")
        for w in list(b._pool._idle):
            w.kill()
            w.wait(timeout=5)
        st = s.run(b, "c5", "open('cold.txt', 'w').write('ran')\n")
        wait_for(lambda: os.path.exists(os.path.join(st.upper_dir,
                                                     "cold.txt")),
                 msg="cold marker")
        wait_for(lambda: len(b._pool._idle) >= 1, msg="refill")
        s.note("refilled", True)
    finally:
        b.close()


def pythonpath_env_bypasses_pool(s):
    b = s.backend()
    try:
        pool_pids = {w.pid for w in b._pool._idle}
        st = s.run(b, "c7", (
            "import os, sys, json\n"
            "json.dump({'pid': os.getpid(),\n"
            "           'ok': '/warm-test-libs' in sys.path},\n"
            "          open('marker.json', 'w'))\n"),
            env=["PYTHONPATH=/warm-test-libs"])
        rec = marker(st)
        s.note("cold", [rec["pid"] not in pool_pids, rec["ok"]])
    finally:
        b.close()


def non_python_cmd_bypasses_pool(s):
    b = s.backend()
    try:
        b.create("c6", s.Spec(image="", cmd=["sleep", "30"]))
        b.start("c6")
        s.note("running", b.inspect("c6").running)
        s.note("idle", len(b._pool._idle) <= 1)
        b.stop("c6", timeout=5)
    finally:
        b.close()


def pool_gives_up_after_consecutive_spawn_failures(s):
    pool = s.warm.WarmPool(size=0, preimport="json", give_up_after=3,
                           backoff_base=0.001, backoff_cap=0.01)
    spawns = []
    pool._spawn = lambda: spawns.append(1) or None
    for _ in range(10):
        pool._add_worker()
    s.note("stats", pool.stats())
    s.note("spawns", len(spawns))
    pool._refill_async()
    time.sleep(0.05)
    s.note("after refill", [len(spawns), pool.take()])
    pool.close()


def pool_dead_idle_workers_count_toward_give_up(s):
    pool = s.warm.WarmPool(size=2, preimport="json", give_up_after=50)
    wait_for(lambda: pool.stats()["idle"] == 2, msg="two workers")
    for w in list(pool._idle):
        w.kill()
        w.wait(timeout=5)
    s.note("dead take", pool.take())
    s.note("streak", pool.stats()["consecFailures"])
    wait_for(lambda: pool.stats()["idle"] >= 1, msg="refill")
    w = pool.take()
    s.note("live take", [w is not None, pool.stats()["consecFailures"]])
    s.warm._reap(w)
    pool.close()


def pool_close_reaps_workers(s):
    b = s.backend(size=2)
    wait_for(lambda: len(b._pool._idle) == 2, msg="two workers")
    workers = list(b._pool._idle)
    b.close()
    s.note("exited", [w.poll() is not None for w in workers])
    s.note("closed take", b._pool.take())


CASES = [warm_start_runs_in_pool_worker,
         warm_worker_is_stoppable_and_exit_code_seen,
         pool_refills_after_take, dead_worker_falls_back_to_cold_spawn,
         pythonpath_env_bypasses_pool, non_python_cmd_bypasses_pool,
         pool_gives_up_after_consecutive_spawn_failures,
         pool_dead_idle_workers_count_toward_give_up,
         pool_close_reaps_workers]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_warm_pool_case_equals_jax(tmp_path, case):
    records = []
    for pkg in ("jax", "port"):
        s = Side(pkg, tmp_path)
        case(s)
        records.append(s.record)
    assert records[1] == records[0]
    assert records[1]


# ---- supports(): JAX's classification but for the import-baked env ----------

PY = sys.executable
COMMANDS = [[PY, "-c", "pass"], [PY, "-u", "-c", "pass"],
            [PY, "-m", "json.tool"], [PY, "script.py", "arg"],
            ["python3", "-c", "pass"], [], ["sleep", "5"], [PY], [PY, "-c"],
            [PY, "-X", "dev", "x.py"]]
ENVS = [None, ["PYTHONPATH=/x"], ["PYTHONHASHSEED=0"], ["FOO=bar", "PY=1"],
        ["XLA_FLAGS=--xla_foo"], ["CUDA_VISIBLE_DEVICES=3"],
        ["CUDA_DEVICE_ORDER=PCI_BUS_ID", "TDAPI_MESH_PLAN={}"]]


@pytest.mark.parametrize("env", ENVS, ids=str)
def test_supports_classifies_as_jax(env):
    for cmd in COMMANDS:
        assert (twarm.WarmPool.supports(cmd, env)
                == jwarm.WarmPool.supports(cmd, env)), (cmd, env)


def test_supports_refuses_the_env_torch_fixes_at_import():
    ok = [PY, "-c", "pass"]
    for kv in ("OMP_NUM_THREADS=1", "MKL_NUM_THREADS=2", "TORCH_LOGS=+dynamo"):
        assert not twarm.WarmPool.supports(ok, [kv]), kv
    # JAX's import-baked and re-pointed variables mean nothing to torch
    assert twarm.WarmPool.supports(ok, ["JAX_DEFAULT_DTYPE_BITS=32"])
    assert twarm.WarmPool.supports(ok, ["JAX_ENABLE_X64=1"])
    assert twarm.WarmPool.IMPORT_BAKED_ENV == (
        "OMP_NUM_THREADS", "MKL_NUM_THREADS", "TORCH_LOGS")


BAKED_PROBE = r"""
import json, os
import torch
import torch._logging._internal as logs
before = (torch.get_num_threads(), dict(logs.log_state.get_log_level_pairs()))
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["TORCH_LOGS"] = "+dynamo"
after = (torch.get_num_threads(), dict(logs.log_state.get_log_level_pairs()))
print(json.dumps([before, after]))
"""


def test_the_refused_env_is_fixed_once_torch_is_imported():
    """Set after `import torch`, OMP_NUM_THREADS and TORCH_LOGS change
    nothing; set before it, they take: why a warm worker refuses them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "TORCH_LOGS")}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", BAKED_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == after
    assert before[0] == 2 and before[1] == {}


# ---- the torch worker and the card guard -------------------------------------

TORCH_PROBE = ("import os, sys, json\n"
               "json.dump({'pid': os.getpid(),\n"
               "           'torch_warm': 'torch' in sys.modules,\n"
               "           'cuda_init': sys.modules['torch'].cuda"
               ".is_initialized() if 'torch' in sys.modules else None,\n"
               "           'cards': os.environ.get('CUDA_VISIBLE_DEVICES'),\n"
               "           'argv': sys.argv},\n"
               "          open('marker.json', 'w'))\n")


#: the deadline of a worker's preimports, `import torch` among them: 2.9-
#: 5.1 s measured with the whole suite beside it under xdist -n 6, while
#: the same wait failed once at 10 s; the job's own start after them (exec
#: included) took 0.1 s and keeps the 10 s default
TORCH_IMPORT_S = 60.0


def stamped(libs, source=""):
    """A preimport module's source that ends by writing libs/imported: the
    worker is through its preimports once that file exists."""
    return source + f"\nopen({str(libs / 'imported')!r}, 'w').close()\n"


def imported(libs):
    wait_for(lambda: (libs / "imported").exists(), timeout=TORCH_IMPORT_S,
             msg="the worker's preimports")


def torch_backend(tmp_path, preimport="torch", env=None):
    return TBackend(str(tmp_path / "b"), warm_pool=1, warm_preimport=preimport,
                    warm_env=env)


def test_torch_worker_leaves_cuda_uninitialised_and_takes_the_grant(
        tmp_path):
    libs = tmp_path / "libs"
    libs.mkdir()
    (libs / "torch_done.py").write_text(stamped(libs))
    b = torch_backend(tmp_path, preimport="torch,torch_done",
                      env={"PYTHONPATH": str(libs)})
    try:
        imported(libs)
        pool_pids = set(b._pool.idle_pids())
        b.create("t1", TSpec(image="", cmd=[PY, "-c", TORCH_PROBE, "x"],
                             tpu_chips=[3],
                             tpu_env={"CUDA_VISIBLE_DEVICES": "3"}))
        b.start("t1")
        rec = marker(b.inspect("t1"))
        assert rec["pid"] in pool_pids and rec["torch_warm"]
        assert rec["cuda_init"] is False
        assert rec["cards"] == "3" and rec["argv"] == ["-c", "x"]
    finally:
        b.close()


def test_a_worker_with_cuda_initialised_starts_its_job_cold(tmp_path):
    """A preimport (on the workers' own PYTHONPATH) that leaves CUDA
    initialised: the worker execs the job instead, in the same process
    (the backend's Popen stays valid), a fresh interpreter without torch,
    with the job's argv and grant."""
    libs = tmp_path / "libs"
    libs.mkdir()
    (libs / "cuda_up.py").write_text(stamped(
        libs, "import torch\ntorch.cuda.is_initialized = lambda: True\n"))
    b = torch_backend(tmp_path, preimport="torch,cuda_up",
                      env={"PYTHONPATH": str(libs)})
    try:
        wait_for(lambda: b._pool.idle_pids(), msg="a worker")
        imported(libs)
        pool_pids = set(b._pool.idle_pids())
        b.create("t2", TSpec(image="", cmd=[PY, "-c", TORCH_PROBE, "y"],
                             tpu_env={"CUDA_VISIBLE_DEVICES": "1"}))
        b.start("t2")
        rec = marker(b.inspect("t2"))
        assert rec["pid"] in pool_pids        # the same process, exec'd
        assert rec["torch_warm"] is False     # a fresh interpreter
        assert rec["cards"] == "1" and rec["argv"] == ["-c", "y"]
        assert "CUDA was initialised before the job" in b.log_text("t2")
        assert b.wait("t2", timeout=30) == 0
    finally:
        b.close()


# A CUDA build of torch maps the driver library (libcuda) at import and
# leaves it uninitialised; `torch.cuda.is_available()` then runs cuInit
# without setting torch's flag. With no driver on this host, a file mapped
# under the driver's name stands in for the library, and the
# driver's answer to cuDeviceGetCount is DRIVER_STATUS: 3
# (CUDA_ERROR_NOT_INITIALIZED) before cuInit, 0 after it.
DRIVER_PROBE = (
    "import ctypes, mmap, os\n"
    "import torch\n"
    "torch.cuda.is_available()\n"
    "assert not torch.cuda.is_initialized()\n"
    "_lib = os.path.join(os.environ['DRIVER_DIR'], 'libcuda.so.1')\n"
    "with open(_lib, 'wb+') as _f:\n"
    "    _f.write(bytes(mmap.PAGESIZE))\n"
    "    _f.flush()\n"
    "    _map = mmap.mmap(_f.fileno(), 0, prot=mmap.PROT_READ)\n"
    "_status = int(os.environ['DRIVER_STATUS'])\n"
    "class _Driver:\n"
    "    def cuDeviceGetCount(self, count):\n"
    "        return _status\n"
    "_real = ctypes.CDLL\n"
    "ctypes.CDLL = lambda name, *a, **k: (\n"
    "    _Driver() if 'libcuda' in str(name) else _real(name, *a, **k))\n")


@pytest.mark.parametrize("status,cold", [(3, False), (0, True)],
                         ids=["driver-mapped-uninitialised-runs-warm",
                              "driver-initialised-starts-cold"])
def test_the_card_guard_asks_the_driver(tmp_path, status, cold):
    """The driver library mapped but uninitialised (torch's import on a
    CUDA build): the job runs warm. Initialised by the preimport's probe,
    with torch's flag unset: the worker execs the job cold, which then
    sees its own grant."""
    libs = tmp_path / "libs"
    libs.mkdir()
    (libs / "probe_driver.py").write_text(stamped(libs, DRIVER_PROBE))
    b = torch_backend(tmp_path, preimport="torch,probe_driver",
                      env={"PYTHONPATH": str(libs), "DRIVER_DIR": str(libs),
                           "DRIVER_STATUS": str(status)})
    try:
        wait_for(lambda: b._pool.idle_pids(), msg="a worker")
        imported(libs)
        pool_pids = set(b._pool.idle_pids())
        b.create("t3", TSpec(image="", cmd=[PY, "-c", TORCH_PROBE, "z"],
                             tpu_env={"CUDA_VISIBLE_DEVICES": "2"}))
        b.start("t3")
        rec = marker(b.inspect("t3"))
        assert rec["pid"] in pool_pids
        assert rec["torch_warm"] is not cold
        assert rec["cards"] == "2" and rec["argv"] == ["-c", "z"]
        assert ("CUDA was initialised before the job"
                in b.log_text("t3")) is cold
        assert b.wait("t3", timeout=30) == 0
    finally:
        b.close()


def test_workers_see_every_card_of_the_node(tmp_path, monkeypatch):
    """A worker's CUDA_VISIBLE_DEVICES is not the daemon's: a preimport
    that probes CUDA sees every card and initialises the driver (which the
    card guard reads), where an empty set would fail cuInit unseen."""
    libs = tmp_path / "libs"
    libs.mkdir()
    (libs / "seen.py").write_text(
        "import os\nopen(os.environ['SEEN_AT'], 'w').write("
        "repr(os.environ.get('CUDA_VISIBLE_DEVICES')))\n")
    seen = tmp_path / "seen.txt"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    pool = twarm.WarmPool(size=1, preimport="seen", env={
        "PYTHONPATH": str(libs), "SEEN_AT": str(seen)})
    try:
        wait_for(seen.exists, msg="preimport")
        assert seen.read_text() == "None"
    finally:
        pool.close()
