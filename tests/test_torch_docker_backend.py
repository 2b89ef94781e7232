"""PyTorch port, the docker backend under the nvidia runtime
(gpu_docker_api_tpu_torch/backend/docker.py) against JAX's, on the fake
dockerd of tests/test_docker_backend.py (a real HTTP server on a real unix
socket).

Every case of that file drives both packages' DockerBackend, each on its
own fake, with the same calls; each call's result (or error) and the
requests each fake received (method, path, query, body) must be equal.
One stated mapping covers the one request that differs, the container
create, whose card grant the port renders as the reference Go code does
(replicaset_nomock.go:128-140) and JAX as TPU passthrough:
- JAX's Devices (/dev/accel* and /dev/vfio/*) and its read-only libtpu
  bind are dropped; the port sends no Devices and no libtpu bind, but
  Runtime "nvidia" and DeviceRequests [{Driver: "cdi", DeviceIDs: the
  CDI names of the granted cards, by their UUIDs in the node's
  topology}];
- the grant env: JAX's TPU_VISIBLE_CHIPS (host indices) reads as
  CUDA_VISIBLE_DEVICES numbered from 0 inside the container (the runtime
  exposes only the granted cards, so a host index would hide the card),
  and the port adds NVIDIA_VISIBLE_DEVICES=void, which keeps an image's
  `NVIDIA_VISIBLE_DEVICES=all` from exposing every card.
Everything else in the payload (binds, lxcfs files, shm, quota, ports,
cpuset, memory, restart policy, the quiesce CONTAINER_ROOT) must be
equal, each side's own directory read as <root>. Then the port alone: the container-local indices and the CDI names
of a grant on cards 3 and 5 whose nodes are not their indices, the index
names of a topology without UUIDs, a container granted no card (the
default runtime, no card seen), and the ReplicaSetService's run through
the docker backend, whose stored record stays JAX's.
"""

import json

import pytest
import torch

import test_docker_backend as JT
from gpu_docker_api_tpu.backend import docker as jdocker
from gpu_docker_api_tpu.dtos import ContainerSpec as JSpec
from gpu_docker_api_tpu_torch import topology as ttopo
from gpu_docker_api_tpu_torch.backend import docker as tdocker
from gpu_docker_api_tpu_torch.dtos import ContainerSpec as TSpec

torch.set_num_threads(1)


class Side:
    def __init__(self, pkg, tmp_path, monkeypatch):
        self.jax = pkg == "jax"
        self.mod = jdocker if self.jax else tdocker
        self.Spec = JSpec if self.jax else TSpec
        root = tmp_path / pkg
        root.mkdir()
        self.fake = JT.FakeDockerd(str(root / "docker.sock"))
        kw = {} if self.jax else {"topology": ttopo.make_topology("h100-8")}
        self.backend = self.mod.DockerBackend(
            str(root / "state"), socket_path=self.fake.server.server_address,
            **kw)
        self.root = str(root)
        self.record = []
        self.mp = monkeypatch

    def close(self):
        self.fake.close()

    def call(self, label, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the error is the result
            out = ("error", type(e).__name__,
                   getattr(e, "status", None))
        self.record.append((label, out))
        return out

    def spec(self, **kw):
        d = dict(image="ubuntu:22.04", cmd=["sleep", "30"], env=["FOO=bar"])
        d.update(kw)
        return self.Spec(**d)

    def requests(self):
        return [self.norm(r) for r in self.fake.requests]

    def norm(self, req):
        method, path, q, body = req
        if isinstance(body, dict) and "HostConfig" in body:
            body = dict(body)
            hc = dict(body["HostConfig"])
            env = list(body["Env"])
            if self.jax:
                hc.pop("Devices", None)
                hc["Binds"] = [b for b in hc["Binds"]
                               if not b.endswith(":ro")]
                env = [e for e in env if not e.startswith(
                    "TPU_VISIBLE_CHIPS=")]
            else:
                for key in ("Runtime", "DeviceRequests"):
                    hc.pop(key, None)
                env = [e for e in env if not e.startswith(
                    ("CUDA_VISIBLE_DEVICES=", "NVIDIA_VISIBLE_DEVICES="))]
            body.update(HostConfig=hc, Env=env)
        # each side's own directory reads as <root>
        return json.loads(json.dumps((method, path, q, body)).replace(
            self.root, "<root>"))


def both(tmp_path, case):
    out = []
    for pkg in ("jax", "port"):
        with pytest.MonkeyPatch.context() as mp:
            s = Side(pkg, tmp_path, mp)
            try:
                case(s)
                out.append((s.record, s.requests()))
            finally:
                s.close()
    return out


# ---- tests/test_docker_backend.py -------------------------------------------

def ping_on_init(s):
    s.record.append(("pinged", ("GET", "/_ping", {}, None)
                     in s.fake.requests))


def create_payload_rendering(s, tmp_path=None):
    root = s.root
    import os
    vfio = os.path.join(root, "vfio")
    os.makedirs(vfio)
    for f in ("0", "vfio"):
        open(os.path.join(vfio, f), "w").close()
    libtpu = os.path.join(root, "libtpu.so")
    open(libtpu, "w").close()
    lxcfs = os.path.join(root, "lxcfs")
    os.makedirs(os.path.join(lxcfs, "proc"))
    for f in ("cpuinfo", "meminfo", "uptime"):
        open(os.path.join(lxcfs, "proc", f), "w").close()
    if s.jax:
        s.mp.setattr(jdocker, "DEV_VFIO_GLOB", f"{vfio}/*")
        s.mp.setattr(jdocker, "LIBTPU_CANDIDATES", (libtpu,))
    s.mp.setattr(s.mod, "LXCFS_DIR", lxcfs)
    grant = dict(devices=["/dev/accel0", "/dev/accel1"],
                 tpu_env={"TPU_VISIBLE_CHIPS": "0,1", "TPU_WORKER_ID": "0"})
    if not s.jax:
        grant = dict(devices=["/dev/nvidia0", "/dev/nvidia1"],
                     tpu_env={"CUDA_VISIBLE_DEVICES": "0,1",
                              "TPU_WORKER_ID": "0"})
    s.call("create", s.backend.create, "rs-1", s.spec(
        binds=[f"{root}/data:/data"], port_bindings={8080: 40001},
        rootfs_quota="30G", shm_bytes=256 * 1024 ** 3, cpuset="0-3",
        memory_bytes=2 * 1024 ** 3, restart_policy="unless-stopped",
        **grant))


def lifecycle_endpoints(s):
    b = s.backend
    s.call("create", b.create, "rs-1", s.spec())
    s.call("start", b.start, "rs-1")
    s.call("running", lambda: b.inspect("rs-1").running)
    s.call("pause", b.pause, "rs-1")
    s.call("paused", lambda: b.inspect("rs-1").paused)
    s.call("restart", b.restart_inplace, "rs-1")
    s.call("state", lambda: (b.inspect("rs-1").running,
                             b.inspect("rs-1").paused))
    s.call("stop", b.stop, "rs-1")
    s.call("stopped", lambda: (b.inspect("rs-1").running,
                               b.inspect("rs-1").exit_code))
    s.call("conflict", b.create, "rs-1", s.spec())
    s.call("remove", b.remove, "rs-1", force=True)
    s.call("gone", lambda: b.inspect("rs-1").exists)


def inspect_maps_upperdir_and_pid(s):
    b = s.backend
    b.create("rs-1", s.spec())
    b.start("rs-1")
    s.call("inspect", lambda: (b.inspect("rs-1").upper_dir,
                               b.inspect("rs-1").pid))


def exec_demux_and_exit_code(s):
    b = s.backend
    b.create("rs-1", s.spec())
    b.start("rs-1")
    s.call("exec", b.execute, "rs-1", ["echo", "hi"], workdir="/app")


def remove_running_requires_force(s):
    b = s.backend
    b.create("rs-1", s.spec())
    b.start("rs-1")
    s.call("remove", b.remove, "rs-1", force=False)
    s.call("remove force", b.remove, "rs-1", force=True)


def list_names_prefix(s):
    for n in ("foo-1", "foo-2", "bar-1"):
        s.backend.create(n, s.spec())
    s.call("list", s.backend.list_names, "foo-")


def commit(s):
    s.backend.create("rs-1", s.spec())
    s.call("commit", s.backend.commit, "rs-1", "myimg:v2")


def volume_quota_opts(s):
    b = s.backend
    s.call("create", lambda: b.volume_create(
        "vol", size_bytes=20 * 1024 ** 3).driver_opts)
    s.call("inspect", lambda: (b.volume_inspect("vol").exists,
                               b.volume_inspect("vol").size_limit_bytes))
    s.call("remove", b.volume_remove, "vol")
    s.call("gone", lambda: b.volume_inspect("vol").exists)


def missing_container_404(s):
    s.call("inspect", lambda: s.backend.inspect("nope").exists)
    s.call("start", s.backend.start, "nope")


def quiesce_without_upper_dir_access(s):
    """The fake's UpperDir is not on this host: the ack cannot be seen,
    so the quiesce reads not-quiesced, as JAX's does."""
    b = s.backend
    b.create("rs-1", s.spec())
    b.start("rs-1")
    s.call("quiesce", b.quiesce, "rs-1", timeout=0.2)


CASES = [ping_on_init, create_payload_rendering, lifecycle_endpoints,
         inspect_maps_upperdir_and_pid, exec_demux_and_exit_code,
         remove_running_requires_force, list_names_prefix, commit,
         volume_quota_opts, missing_container_404,
         quiesce_without_upper_dir_access]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_docker_case_equals_jax(tmp_path, case):
    (jrec, jreq), (trec, treq) = both(tmp_path, case)
    assert trec == jrec
    assert [r for r in treq] == [r for r in jreq]
    assert jreq


# ---- the port alone: the nvidia runtime's payload ----------------------------

@pytest.fixture
def port(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        s = Side("port", tmp_path, mp)
        yield s
        s.close()


def created_body(s):
    return next(r for r in s.fake.requests
                if r[1].endswith("/containers/create"))[3]


def discovered(n, uuids=True):
    """A node of n cards as discovery reads it: nodes by nvidia-smi's minor
    number (2 * index + 1 here, not the index), UUIDs where probed."""
    return ttopo.GpuTopology(f"h100-{n}", "h100", (n, 1, 1), chips=[
        ttopo.Chip(i, (i, 0, 0), f"/dev/nvidia{2 * i + 1}",
                   f"GPU-{i:04x}aaaa" if uuids else "", "H100")
        for i in range(n)], chips_per_host=n)


def test_cdi_device_request_and_container_local_indices(port):
    port.backend.topology = discovered(8)
    port.backend.create("rs-1", port.spec(
        tpu_chips=[3, 5], devices=["/dev/nvidia7", "/dev/nvidia11"],
        tpu_env={"CUDA_VISIBLE_DEVICES": "3,5",
                 "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
                 "TDAPI_MESH_PLAN": '{"dp": 2}'}))
    body = created_body(port)
    hc = body["HostConfig"]
    assert hc["Runtime"] == "nvidia"
    assert hc["DeviceRequests"] == [{
        "Driver": "cdi",
        "DeviceIDs": ["nvidia.com/gpu=GPU-0003aaaa",
                      "nvidia.com/gpu=GPU-0005aaaa"]}]
    assert "Devices" not in hc
    env = dict(e.split("=", 1) for e in body["Env"])
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1"        # not the host's 3,5
    assert env["NVIDIA_VISIBLE_DEVICES"] == "void"
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    assert env["TDAPI_MESH_PLAN"] == '{"dp": 2}'
    assert env["CONTAINER_ROOT"] == "/" and env["FOO"] == "bar"
    assert not any("libtpu" in b for b in hc["Binds"])


def test_cdi_names_fall_back_to_the_index_and_refuse_a_stranger(port):
    """A topology without UUIDs (a mock) names a card by its index on the
    node; a device node that is no card of the node is refused."""
    from gpu_docker_api_tpu_torch.backend.docker import cdi_names
    topo = discovered(4, uuids=False)
    assert cdi_names(topo, ["/dev/nvidia5", "/dev/nvidia1"]) == [
        "nvidia.com/gpu=2", "nvidia.com/gpu=0"]
    with pytest.raises(ValueError, match="/dev/nvidia2"):
        cdi_names(topo, ["/dev/nvidia2"])
    second = ttopo.make_topology("h100-16", worker_id=1)
    assert cdi_names(second, [second.chip(9).device_path]) == [
        "nvidia.com/gpu=1"]


def test_a_container_without_a_card_sees_none(port):
    port.backend.create("rs-1", port.spec())
    body = created_body(port)
    assert "Runtime" not in body["HostConfig"]
    assert "DeviceRequests" not in body["HostConfig"]
    env = dict(e.split("=", 1) for e in body["Env"])
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["NVIDIA_VISIBLE_DEVICES"] == "void"


def test_the_service_runs_a_card_grant_through_the_docker_backend(port,
                                                                  tmp_path):
    """ReplicaSetService over DockerBackend on a discovered-style line
    (cards with nvidia-smi UUIDs): the create asks the runtime for the
    granted card by its UUID, numbered 0 inside."""
    from test_torch_services import World
    topo = discovered(2)
    port.backend.topology = topo
    w = World("svc", tmp_path, backend=port.backend)
    try:
        from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
        w.tpu = w.rs.tpu = GpuScheduler(w.client, w.wq, topology=topo)
        w.rs.tpu.apply(1, "other")                    # card 0 is taken
        out = w.run("svc", tpus=1, cpus=0, ports=0)
        assert out["tpuChips"] == [1]
        body = created_body(port)
        assert body["HostConfig"]["DeviceRequests"][0]["DeviceIDs"] == [
            "nvidia.com/gpu=GPU-0001aaaa"]
        env = dict(e.split("=", 1) for e in body["Env"])
        assert env["CUDA_VISIBLE_DEVICES"] == "0"
        spec = w.rs._stored_info("svc").spec
        assert spec.devices == ["/dev/nvidia3"]
        assert spec.tpu_env["CUDA_VISIBLE_DEVICES"] == "1"   # the host's
        assert "device_ids" not in spec.to_json()            # JAX's record
    finally:
        w.close()
