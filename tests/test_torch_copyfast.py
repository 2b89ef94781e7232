"""PyTorch port, the data-movement subsystem
(gpu_docker_api_tpu_torch/utils/copyfast.py) against JAX's.

Every case of tests/test_copyfast.py runs twice on the same inputs: as it
is, on the JAX package, and with each name it took from the JAX package
rebound to the port's counterpart (the card scheduler on an `h100-16`
line where it builds a TpuScheduler on `v4-32`; the rolling-replace cases
drive the port's ReplicaSetService). Both runs must pass the case's own
assertions, and the stats each clone_tree / delta_sync /
move_dir_contents call of the case returns must be equal between them:
files, bytes, delta files, deletions and the resolved mode rung. Only the
wall-clock `seconds` of a stats record is left out, so no case races the
clock.
"""

import dataclasses
import inspect
import os
import types

import pytest
import torch

import test_copyfast as J
from gpu_docker_api_tpu_torch import dtos as tdtos
from gpu_docker_api_tpu_torch import topology as ttopo
from gpu_docker_api_tpu_torch.backend import MockBackend as TMock
from gpu_docker_api_tpu_torch.events import EventLog as TEvents
from gpu_docker_api_tpu_torch.schedulers import CpuScheduler as TCpu
from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
from gpu_docker_api_tpu_torch.schedulers import PortScheduler as TPorts
from gpu_docker_api_tpu_torch.services import ReplicaSetService as TRs
from gpu_docker_api_tpu_torch.store import MVCCStore as TStore
from gpu_docker_api_tpu_torch.store import StateClient as TClient
from gpu_docker_api_tpu_torch.utils import copyfast as tcf
from gpu_docker_api_tpu_torch.version import MergeMap as TMerge
from gpu_docker_api_tpu_torch.version import VersionMap as TVersions
from gpu_docker_api_tpu_torch.workqueue import WorkQueue as TQueue

torch.set_num_threads(1)


class _PortDirtyOnStopBackend(TMock):
    """tests/test_copyfast.py's _DirtyOnStopBackend over the port's mock:
    a write lands in the stopping container's layer just before the stop."""

    def __init__(self, state_dir):
        super().__init__(state_dir)
        self.dirty_on_stop = True

    def stop(self, name, timeout=10.0):
        if self.dirty_on_stop:
            st = self.inspect(name)
            if st.exists and st.upper_dir:
                with open(os.path.join(st.upper_dir, "flushed.state"),
                          "w") as f:
                    f.write("written during stop")
        super().stop(name, timeout)


#: the names tests/test_copyfast.py takes from the JAX package, rebound
PORT_NAMES = {
    "MockBackend": TMock, "ContainerRun": tdtos.ContainerRun,
    "MemoryPatch": tdtos.MemoryPatch, "PatchRequest": tdtos.PatchRequest,
    "EventLog": TEvents, "CpuScheduler": TCpu, "PortScheduler": TPorts,
    "TpuScheduler": GpuScheduler, "ReplicaSetService": TRs,
    "MVCCStore": TStore, "StateClient": TClient,
    "make_topology": lambda _type: ttopo.make_topology("h100-16"),
    "copyfast": tcf, "_Unsupported": tcf._Unsupported,
    "clone_tree": tcf.clone_tree, "delta_sync": tcf.delta_sync,
    "move_dir_contents": tcf.move_dir_contents,
    "snapshot_tree": tcf.snapshot_tree, "MergeMap": TMerge,
    "VersionMap": TVersions, "WorkQueue": TQueue,
    "_DirtyOnStopBackend": _PortDirtyOnStopBackend,
}
RECORDED = ("clone_tree", "delta_sync", "move_dir_contents")


def stats_of(out):
    if dataclasses.is_dataclass(out):
        d = dataclasses.asdict(out)
        d.pop("seconds", None)
        return d
    return type(out).__name__


def side(port, calls):
    """The globals a case runs under: the JAX test module's own, or with
    every JAX name rebound to the port's. Each recorded copy call appends
    its stats to `calls`."""
    g = dict(vars(J))
    if port:
        g.update(PORT_NAMES)
    for name in RECORDED:
        real = g[name]

        def recorder(*a, _real=real, _name=name, **kw):
            out = _real(*a, **kw)
            calls.append((_name, stats_of(out)))
            return out
        g[name] = recorder
    return g


def world(g, tmp_path):
    """tests/test_copyfast.py's world fixture under globals `g`."""
    store = g["MVCCStore"]()
    client = g["StateClient"](store)
    wq = g["WorkQueue"](client)
    wq.start()
    backend = g["_DirtyOnStopBackend"](str(tmp_path / "state"))
    tpu = g["TpuScheduler"](client, wq, topology=g["make_topology"]("v4-32"))
    cpu = g["CpuScheduler"](client, wq, core_count=16)
    ports = g["PortScheduler"](client, wq, port_range=(43000, 43100), seed=7)
    events = g["EventLog"]()
    rs = g["ReplicaSetService"](backend, client, wq, tpu, cpu, ports,
                                g["VersionMap"]("containerVersionMap",
                                                client, wq),
                                g["MergeMap"](client, wq), events=events)
    return (rs, backend, events), wq


def cases():
    out = []
    for name, fn in sorted(vars(J).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = getattr(fn, "pytestmark", [])
        modes = [m.args[1] for m in marks if m.name == "parametrize"]
        for mode in (modes[0] if modes else [None]):
            out.append(pytest.param(name, mode,
                                    id=name + (f"-{mode}" if mode else "")))
    return out


def run_case(name, mode, g, tmp_path, monkeypatch, port):
    fn = types.FunctionType(getattr(J, name).__code__, g, name)
    params = inspect.signature(fn).parameters
    kw, wq = {}, None
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    if "monkeypatch" in params:
        kw["monkeypatch"] = monkeypatch
    if "mode" in params:
        kw["mode"] = mode
    if "world" in params:
        kw["world"], wq = world(g, tmp_path)
    if port:
        # the case's own `from gpu_docker_api_tpu.utils.file import
        # copy_dir` names the JAX module, whose copy_dir is a clone_tree:
        # give it the port's clone_tree
        import gpu_docker_api_tpu.utils.file as jfile
        monkeypatch.setattr(jfile, "copy_dir",
                            lambda src, dest: tcf.clone_tree(src, dest))
    try:
        fn(**kw)
    finally:
        if wq is not None:
            wq.close()


@pytest.mark.parametrize("name,mode", cases())
def test_copyfast_case_equals_jax(tmp_path, name, mode):
    records = []
    for port in (False, True):
        calls = []
        sub = tmp_path / ("port" if port else "jax")
        sub.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            run_case(name, mode, side(port, calls), sub, mp, port)
        records.append(calls)
    assert records[1] == records[0]


def test_every_jax_copyfast_case_is_mirrored():
    """Every test of tests/test_copyfast.py runs here, and every name it
    imports from the JAX package has the port's counterpart."""
    imported = {n for n, v in vars(J).items()
                if getattr(v, "__module__", "").startswith(
                    "gpu_docker_api_tpu.")
                or isinstance(v, types.ModuleType)
                and v.__name__.startswith("gpu_docker_api_tpu.")}
    assert imported <= set(PORT_NAMES)
    assert len(cases()) >= 30
