"""PyTorch port, the sharding layout of the dp, fsdp and tp axes
(parallel/mesh.py, parallel/comm.py) against the JAX package: the rank
layout against make_mesh's devices, param_kinds and the specs param_specs
gives each leaf, each rank's shard against the shard JAX puts on the same
device (under fsdp, tp and both, embed's tp-major vocab chunks included),
the refusal of uneven parameter dims and batches, and the fsdp all-gather
and its gradient, the reduce-scatter, over two gloo ranks against one
process."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel import mesh as jmesh
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import family_for
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.parallel import mesh as tmesh
from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup

torch.set_num_threads(1)

PLANS_8 = [dict(fsdp=8), dict(dp=2, fsdp=4), dict(dp=2, fsdp=2, sp=2),
           dict(fsdp=2, tp=2, sp=2), dict(dp=2, pp=2, ep=2),
           dict(fsdp=4, sp=2)]
CONFIGS = [("llama", "tiny"), ("llama", "llama_1b"), ("moe", "tiny"),
           ("moe", "moe_1b")]


def _configs(family, name):
    mod = {"llama": (jllama.LlamaConfig, tllama.LlamaConfig),
           "moe": (jmoe.MoEConfig, tmoe.MoEConfig)}[family]
    return getattr(mod[0], name)(), getattr(mod[1], name)()


def _jspec(p):
    """A JAX PartitionSpec as the port writes it: a tuple per dim."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


@pytest.mark.parametrize("plan", PLANS_8)
def test_rank_layout_is_the_jax_mesh(plan):
    jm = jmesh.make_mesh(jmesh.MeshPlan(**plan), jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    tp = tmesh.MeshPlan(**plan)
    np.testing.assert_array_equal(tmesh.make_mesh(tp), ids)
    assert tmesh.AXES == jmesh.AXES
    for rank in range(8):
        at = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert tuple(tmesh.coords(tp, rank).values()) == at
    # the groups MeshGroups forms: every line along the axes, in order
    for axes in (("fsdp",), ("tp",), ("dp", "sp"), ("sp",), tmesh.AXES,
                 tuple(a for a in tmesh.AXES if a != "tp")):
        lines = tmesh.axis_lines(tp, axes)
        assert sorted(r for line in lines for r in line) == list(range(8))
        for line in lines:
            others = [{a: v for a, v in tmesh.coords(tp, r).items()
                       if a not in axes} for r in line]
            assert all(o == others[0] for o in others)


@pytest.mark.parametrize("family, name", CONFIGS)
def test_param_kinds_and_specs_equal_the_jax_ones(family, name):
    jcfg, tcfg = _configs(family, name)
    jmod = {"llama": jllama, "moe": jmoe}[family]
    assert family_for(tcfg).param_kinds(tcfg) == jmod.param_kinds(jcfg)
    jspecs = jtrain.param_specs(jcfg)
    tspecs = ttrain.param_specs(tcfg)
    assert tspecs.keys() == jspecs.keys()
    for key in ("embed", "final_norm", "lm_head"):
        assert tspecs[key] == _jspec(jspecs[key])
    assert tspecs["layers"].keys() == jspecs["layers"].keys()
    for key, spec in jspecs["layers"].items():
        assert tspecs["layers"][key] == _jspec(spec)
        # the fsdp dim is where "fsdp" sits in the stacked JAX spec
        where = [i for i, e in enumerate(_jspec(spec))
                 if e == "fsdp" or isinstance(e, tuple) and "fsdp" in e]
        assert tmesh.spec_dim(tspecs["layers"][key], "fsdp") == (
            where[0] if where else None)
    assert {k: _jspec(v) for k, v in jmesh.param_sharding_rules().items()} \
        == tmesh.param_sharding_rules()
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert tmesh.batch_spec() == _jspec(jmesh.batch_spec())


@pytest.mark.parametrize("plan", [
    pytest.param(dict(fsdp=2), id="2"), pytest.param(dict(fsdp=4), id="4"),
    pytest.param(dict(tp=2), id="tp2"), pytest.param(dict(tp=4), id="tp4"),
    pytest.param(dict(fsdp=2, tp=2), id="fsdp2xtp2")])
def test_each_ranks_shard_is_the_one_jax_puts_on_its_device(plan):
    """shard_params on rank r gives, leaf by leaf and bit for bit, the
    shard JAX places on device r of the same plan's mesh; unshard of the
    ranks' shards gives the leaf back."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                       jax.random.key(1)))
    params = convert.params_from_numpy(tree, tcfg)
    specs = ttrain.param_specs(tcfg)
    tplan = tmesh.MeshPlan(**plan)
    n = tplan.size
    jm = jmesh.make_mesh(jmesh.MeshPlan(**plan), jax.devices()[:n])
    jspecs = jtrain.param_specs(jcfg)
    shards = [tmesh.shard_params(params, specs, tplan, r) for r in range(n)]
    for path, leaf in ttrain.tree_leaves(ttrain.tree_map_named(
            lambda path, t: (path, t), params)):
        keys = path.split(".")
        jspec = jspecs[keys[0]] if len(keys) == 1 else \
            jspecs[keys[0]][keys[1]]
        jleaf = tree[keys[0]] if len(keys) == 1 else tree[keys[0]][keys[1]]
        placed = jax.device_put(jleaf, NamedSharding(jm, jspec))
        by_device = {s.device.id: np.asarray(s.data)
                     for s in placed.addressable_shards}
        mine = []
        for r in range(n):
            got = shards[r]
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), by_device[r])
            mine.append(got)
        spec = specs[keys[0]] if len(keys) == 1 else specs[keys[0]][keys[1]]
        assert torch.equal(tmesh.unshard(mine, spec, tplan), leaf)


def _groups(plan, rank=0):
    """This rank's MeshGroups of `plan` without process groups (nothing
    here reaches a collective)."""
    size = AxisGroup(None, rank, plan.size)
    fsdp = AxisGroup(None, rank, plan.fsdp) if plan.fsdp > 1 else None
    return tmesh.MeshGroups(plan, rank, fsdp=fsdp, world=size)


def test_uneven_parameter_dims_raise_as_in_jax():
    """fsdp=3 on tiny: embed's dim 0 of 256 does not divide."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jtr = jtrain.Trainer.create(jcfg, jmesh.MeshPlan(fsdp=3),
                                devices=jax.devices()[:3])
    with pytest.raises(ValueError):
        jtr.init(jax.random.key(0))
    plan = tmesh.MeshPlan(fsdp=3)
    with pytest.raises(ValueError, match="embed: dim 0 of .* fsdp 3"):
        ttrain.Trainer.create(tcfg, plan, device="cpu",
                              groups=_groups(plan))
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not divide over fsdp 3"):
        tmesh.shard_params(params, ttrain.param_specs(tcfg), plan, 0)


@pytest.mark.parametrize("plan, leaf, over", [
    (dict(tp=3), "embed: dim 0 of \\(256, 64\\)", "tp 3"),
    (dict(fsdp=2, tp=3), "embed: dim 0 of \\(256, 64\\)", "tp 3 x fsdp 2")])
def test_uneven_tp_dims_raise_as_in_jax(plan, leaf, over):
    """tp=3 on tiny: the vocab of 256 does not divide; under fsdp=2 too
    the message names both axes of embed's dim 0, tp major."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    size = jmesh.MeshPlan(**plan).size
    jtr = jtrain.Trainer.create(jcfg, jmesh.MeshPlan(**plan),
                                devices=jax.devices()[:size])
    with pytest.raises(ValueError):
        jtr.init(jax.random.key(0))
    tplan = tmesh.MeshPlan(**plan)
    with pytest.raises(ValueError, match=f"{leaf} does not divide over "
                                         f"{over}$"):
        ttrain.Trainer.create(tcfg, tplan, device="cpu",
                              groups=_groups(tplan))


def test_uneven_batches_raise_as_in_jax():
    """fsdp=2 with B=3 rows."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jtr = jtrain.Trainer.create(jcfg, jmesh.MeshPlan(fsdp=2),
                                devices=jax.devices()[:2])
    toks = np.zeros((3, 8), np.int32)
    with pytest.raises(ValueError):
        jtr.shard_batch(toks)
    for plan in (tmesh.MeshPlan(fsdp=2), tmesh.MeshPlan(dp=2)):
        tr = ttrain.Trainer.create(tcfg, plan, device="cpu",
                                   groups=_groups(plan))
        with pytest.raises(ValueError, match="batch 3 does not divide"):
            tr.shard_batch(toks)
    tr = ttrain.Trainer.create(tcfg, plan, device="cpu",
                               groups=_groups(plan, rank=1))
    rows = np.arange(32).reshape(4, 8)
    assert tr.shard_batch(rows).tolist() == rows[2:].tolist()


def test_all_gather_and_its_gradient_over_two_ranks(tmp_path):
    """Over 2 gloo ranks, in one collective: f32 and bf16 shards along
    dims 0, 1 and 2 gathered whole, bit for bit; each rank's gradient of
    its own cotangents is its slice of their sum over the ranks, the
    gradient of the one-process concatenation (sum in f32)."""
    rng = np.random.default_rng(0)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    shapes = [((4, 6), 0, torch.float32), ((2, 4, 6), 1, torch.float32),
              ((2, 4, 6), 2, torch.float32), ((8, 4), 0, torch.bfloat16)]
    case = {"name": "mixed", "dims": [d for _, d, _ in shapes],
            "tensors": [rand(*s, dtype=t) for s, _, t in shapes],
            "cotangents": [[rand(*s, dtype=t) for s, _, t in shapes]
                           for _ in range(2)]}
    ranks = workers.run(workers.gather_cases, [case], 2, str(tmp_path))
    shards = [[t.chunk(2, dim=d)[r].clone().requires_grad_(True)
               for t, d in zip(case["tensors"], case["dims"])]
              for r in range(2)]
    total = [(a.float() + b.float()).to(a.dtype)
             for a, b in zip(*case["cotangents"])]
    for i, (s, d, _) in enumerate(shapes):
        whole = torch.cat([shards[r][i] for r in range(2)], dim=d)
        want = torch.autograd.grad(whole, [shards[r][i] for r in range(2)],
                                   total[i])
        for r, res in enumerate(ranks):
            got = res["mixed"]
            assert torch.equal(got["full"][i], case["tensors"][i])
            assert torch.equal(got["leaf"][i], case["tensors"][i])
            assert got["grads"][i].dtype == case["tensors"][i].dtype
            assert torch.equal(got["grads"][i], want[r])
            assert torch.equal(got["scattered"][i], want[r])
