"""PyTorch port, data.py and parallel/mesh.py: the port's own copies give
the JAX package's batches and read the control plane's mesh contract the
same way."""

import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import data as jdata
from gpu_docker_api_tpu.parallel import mesh as jmesh
from gpu_docker_api_tpu_torch import data as tdata
from gpu_docker_api_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


@pytest.mark.parametrize("source", ["synthetic", "u16", "u32"])
def test_batches_equal_the_jax_package(tmp_path, source):
    path = ""
    if source != "synthetic":
        dtype = np.uint16 if source == "u16" else np.uint32
        path = str(tmp_path / f"tokens.{source}")
        np.arange(5000, dtype=dtype).tofile(path)
    j = jdata.make_dataset(path, 6000, 3, 17, seed=9)
    t = tdata.make_dataset(path, 6000, 3, 17, seed=9)
    for step in (0, 1, 41):
        np.testing.assert_array_equal(t.batch_at(step), j.batch_at(step))


def test_prefetcher_places_batches_in_order():
    ds = tdata.SyntheticDataset(100, 2, 8, seed=3)
    pf = tdata.Prefetcher(ds.iter_from(5),
                          place=lambda b: tdata.to_device(
                              b, torch.device("cpu")))
    try:
        for step in (5, 6, 7):
            got = next(pf)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), ds.batch_at(step))
    finally:
        pf.close()


def test_prefetcher_reraises_the_producer_error(tmp_path):
    path = str(tmp_path / "big.u16")
    np.full(100, 999, np.uint16).tofile(path)
    ds = tdata.make_dataset(path, 10, 1, 8)
    pf = tdata.Prefetcher(ds.iter_from(0), place=lambda b: b)
    with pytest.raises(ValueError, match="vocab"):
        next(pf)
    pf.close()


@pytest.mark.parametrize("raw", [
    "", '{"dp": 2, "tp": 2}', '{"fsdp": 4}', "[1]", "{bad", '{"xx": 1}',
    '{"dp": 2.5}', '{"tp": true}', '{"sp": 0}',
])
def test_plan_from_env_matches_jax(raw):
    env = {"TDAPI_MESH_PLAN": raw}

    def parse(mod):
        try:
            plan = mod.plan_from_env(env)
        except ValueError as e:
            return "error", str(e)
        return "plan", None if plan is None else (plan.size, str(plan))

    assert parse(tmesh) == parse(jmesh)


def test_mesh_plan_auto_and_single_device():
    assert str(tmesh.MeshPlan.auto(8, tp=2)) == str(jmesh.MeshPlan.auto(
        8, tp=2))
    with pytest.raises(ValueError):
        tmesh.MeshPlan.auto(6, tp=4)
    # every axis is ported: each plan's rank coordinates are JAX's mesh
    # layout, pp between fsdp and ep, and pp cuts the stacked layer dim
    for plan in (tmesh.MeshPlan(), tmesh.MeshPlan(sp=4),
                 tmesh.MeshPlan(dp=2, fsdp=2, sp=2),
                 tmesh.MeshPlan(fsdp=2, pp=2),
                 tmesh.MeshPlan(fsdp=2, tp=2, sp=2),
                 tmesh.MeshPlan(sp=2, tp=2, ep=2),
                 tmesh.MeshPlan(sp=2, tp=2, ep=2, pp=2)):
        assert tmesh.AXES == ("dp", "fsdp", "pp", "ep", "tp", "sp")
        assert tmesh.make_mesh(plan).shape == tuple(
            getattr(plan, a) for a in tmesh.AXES)
        cut = tmesh.split_dims(("pp", "fsdp", "tp"), plan)
        assert [a for a, _ in cut] == [a for a in ("fsdp", "tp", "pp")
                                       if getattr(plan, a) > 1]
