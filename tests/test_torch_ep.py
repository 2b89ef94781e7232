"""PyTorch port, the pieces of expert parallelism and MoE routing over ranks
against the JAX package, on the CPU: the global slot positions of every
rank's choices (models/moe.block_counts / place_blocks) against JAX's
capacity_positions of the whole batch, under row shards and under sp;
each rank's share of the router losses (router_losses) against JAX's
moe_block aux and z; moe_block itself over gloo ranks (the ep dispatch,
comm.exchange_rows, and the gather path on global slots) against JAX's
moe_block on the whole batch (output, aux, z) and against the port's own
one-rank gather path (every gradient); the rows and bank shards a rank
holds under ep against JAX's placement. Three planted faults must be
caught: a rank-local capacity and prefix, a rank-major prefix under sp and
a mean of rank-local aux values.

Tolerances: positions, keep and placement are exact; f32 values 1e-5
(summation order). The capacity factor is 0.5, so choices drop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel import mesh as jmesh
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.parallel import mesh as tmesh
from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CF = 0.5
B, S = 4, 16
# (row shards, sequence shards) of the routing group
LAYOUTS = [(2, 1), (4, 1), (1, 2), (2, 2)]


def _configs():
    return (dataclasses.replace(jmoe.MoEConfig.tiny(), capacity_factor=CF),
            dataclasses.replace(tmoe.MoEConfig.tiny(), capacity_factor=CF))


def _picks(seed, e=4, k=2):
    """[B*S, K, E] one-hot top-k picks crowding experts 0 and 1, as a
    router whose two favourites overflow."""
    rng = np.random.default_rng(seed)
    p = np.array([0.4, 0.3, 0.2, 0.1])[:e]
    idx = np.stack([rng.choice(e, k, replace=False, p=p)
                    for _ in range(B * S)])
    return np.eye(e, dtype=np.int32)[idx]


def _rank_tokens(x, n_rows, n_sp, j):
    """Rank j's tokens of a global [B, S, ...] array, flattened to [T,
    ...]: its row shard j // n_sp, its sequence shard j % n_sp."""
    r, p = divmod(j, n_sp)
    rows = x.reshape(B, S, *x.shape[1:])[r * B // n_rows:(r + 1) * B // n_rows]
    part = rows[:, p * S // n_sp:(p + 1) * S // n_sp]
    return part.reshape(-1, *x.shape[1:])


def _global_positions(onehot, n_rows, n_sp, place=None):
    """Each simulated rank's global positions (place_blocks over every
    rank's block_counts) and top-1 counts, as the ranks compute them."""
    place = place or tmoe.place_blocks
    rows = B // n_rows
    mine = [torch.from_numpy(_rank_tokens(onehot, n_rows, n_sp, j))
            for j in range(n_rows * n_sp)]
    blocks = [tmoe.block_counts(oh, rows) for oh in mine]
    every = torch.stack([c for _, _, c in blocks])
    return [place(oh, within, every, j, n_sp)
            for j, (oh, within, _) in enumerate(blocks)]


def _rank_local_positions(onehot, n_rows, n_sp):
    """The planted fault: each rank's global_positions of its own tokens
    without the routing group (a rank-local prefix)."""
    return [(tmoe.global_positions(torch.from_numpy(
        _rank_tokens(onehot, n_rows, n_sp, j)), B // n_rows)[0], None)
        for j in range(n_rows * n_sp)]


def _positions_equal_jax(onehot, got, n_rows, n_sp) -> bool:
    want = np.asarray(jmoe.capacity_positions(jnp.asarray(onehot)))
    return all(np.array_equal(pos.numpy(),
                              _rank_tokens(want, n_rows, n_sp, j))
               for j, (pos, _) in enumerate(got))


@pytest.mark.parametrize("n_rows, n_sp", LAYOUTS)
def test_global_positions_are_capacity_positions_of_the_whole_batch(
        n_rows, n_sp):
    """Every rank's positions are JAX's capacity_positions of the global
    [B*S] array at its tokens, and its top-1 counts the global ones; a
    rank-local prefix is caught, and so, under sp, is a rank-major one."""
    onehot = _picks(n_rows * 10 + n_sp)
    got = _global_positions(onehot, n_rows, n_sp)
    assert _positions_equal_jax(onehot, got, n_rows, n_sp)
    top1 = onehot[:, 0].sum(axis=0)
    assert all(np.array_equal(t.numpy(), top1) for _, t in got)
    cap = _configs()[1].capacity(B * S)
    want = np.asarray(jmoe.capacity_positions(jnp.asarray(onehot)))
    assert (want >= cap).any(), "choices must drop past the capacity"
    # the planted faults
    assert not _positions_equal_jax(
        onehot, _rank_local_positions(onehot, n_rows, n_sp), n_rows, n_sp)
    rank_major = _global_positions(onehot, n_rows, n_sp,
                                   workers.rank_major_place)
    assert _positions_equal_jax(onehot, rank_major, n_rows, n_sp) == (
        n_sp == 1), "a rank-major prefix is right only without sp"


def _route_inputs(seed):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = _configs()
    x = (rng.standard_normal((B, S, tcfg.d_model))
         + 2.0 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    x.setflags(write=True)
    layer = {k: np.asarray(v[0]) for k, v in jax.tree.map(
        np.asarray, jmoe.init_params(jcfg, jax.random.key(seed))["layers"]
    ).items() if k in ("mlp_norm", "router", "we1", "we3", "we2")}
    layer["router"] = layer["router"] * 20.0     # sharper routing
    return jcfg, tcfg, x, layer


def _jax_block(jcfg, x, layer):
    out, aux, z = jmoe.moe_block(jnp.asarray(x), jax.tree.map(
        jnp.asarray, layer), jcfg)
    return np.asarray(out), float(aux), float(z)


def _shares(tcfg, x, layer, n_rows, n_sp, local_aux=False):
    """The router-loss shares of each simulated rank, summed: each rank's
    router_losses of its tokens under the global top-1 share; or, the
    planted fault, the mean over ranks of each rank's own aux."""
    from gpu_docker_api_tpu_torch.models.llama import rms_norm
    n = n_rows * n_sp
    h = rms_norm(torch.from_numpy(x), torch.from_numpy(layer["mlp_norm"]),
                 tcfg.norm_eps).reshape(B * S, -1)
    routes = [tmoe._route(torch.from_numpy(_rank_tokens(h.numpy(), n_rows,
                                                        n_sp, j)),
                          torch.from_numpy(layer["router"]), tcfg)
              for j in range(n)]
    frac = sum(r[4] for r in routes) / n        # every rank's T is B*S/n
    aux = z = 0.0
    for logits, probs, *_, in routes:
        a, zz = tmoe.router_losses(logits, probs, frac, B * S, tcfg)
        aux, z = aux + float(a), z + float(zz)
    if local_aux:
        aux = sum(tcfg.n_experts * float((r[4] * r[1].mean(dim=0)).sum())
                  for r in routes) / n
    return aux, z


@pytest.mark.parametrize("n_rows, n_sp", LAYOUTS)
def test_router_loss_shares_sum_to_jax_aux_and_z(n_rows, n_sp):
    """The ranks' shares of aux and z sum to JAX's moe_block aux and z of
    the whole batch; the mean of rank-local aux values (the planted
    fault) does not."""
    jcfg, tcfg, x, layer = _route_inputs(3)
    _, jaux, jz = _jax_block(jcfg, x, layer)
    aux, z = _shares(tcfg, x, layer, n_rows, n_sp)
    assert aux == pytest.approx(jaux, rel=1e-5)
    assert z == pytest.approx(jz, rel=1e-5)
    bad, _ = _shares(tcfg, x, layer, n_rows, n_sp, local_aux=True)
    assert bad != pytest.approx(jaux, rel=1e-5)


# ---- moe_block over gloo ranks ----------------------------------------------

BLOCK_PLANS = {2: [dict(ep=2), dict(dp=2), dict(sp=2), dict(tp=2)],
               4: [dict(ep=4), dict(dp=2, ep=2), dict(ep=2, sp=2),
                   dict(ep=2, tp=2)]}


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    """JAX's moe_block of the whole batch, the port's one-rank moe_block
    (the gather path) with its gradients, and every plan's ranks."""
    jcfg, tcfg, x, layer = _route_inputs(11)
    cot = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    want = _jax_block(jcfg, x, layer)
    one = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in layer.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    calls = []
    route = tmoe._route

    def recording(*args):
        calls.append(route(*args))
        return calls[-1]
    tmoe._route = recording
    try:
        out, aux, z = tmoe.moe_block(xt, one, tcfg)
    finally:
        tmoe._route = route
    keys = list(one)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + aux + z,
                                [xt] + [one[k] for k in keys])
    ranks = {}
    for world, plans in BLOCK_PLANS.items():
        got = workers.run(workers.moe_block_cases, dict(
            config=tcfg, layer=layer, x=x, cot=cot, plans=plans), world,
            str(tmp_path_factory.mktemp(f"block{world}")))
        for p in plans:
            ranks[str(tmesh.MeshPlan(**p))] = (p, [r[str(tmesh.MeshPlan(
                **p))] for r in got])
    return (want, (out.detach(), float(aux.detach()), float(z.detach()),
                   dict(zip(["x"] + keys, grads)), calls[0]), tcfg, ranks)


PLAN_IDS = [str(tmesh.MeshPlan(**p)) for ps in BLOCK_PLANS.values()
            for p in ps]


@pytest.mark.parametrize("name", PLAN_IDS)
def test_moe_block_over_ranks_matches_jax_and_one_rank(block_runs, name):
    """Each rank's output is JAX's moe_block of the whole batch at its
    tokens; the aux and z shares sum (over the ranks of one tp line) to
    JAX's; the gradients, summed as the Trainer sums them, are the
    one-rank gather path's at each rank's shard. Choices drop."""
    (jout, jaux, jz), (out, aux, z, grads, route), tcfg, ranks = block_runs
    assert not bool(route[6].all()), "capacity must drop choices here"
    assert aux == pytest.approx(jaux, rel=1e-5)
    assert z == pytest.approx(jz, rel=1e-5)
    plan_d, got = ranks[name]
    plan = tmesh.MeshPlan(**plan_d)
    rules = tmesh.param_sharding_rules()
    kinds = tmoe.param_kinds(tcfg)["layers"]
    line = [r for r in range(plan.size) if tmesh.coords(plan, r)["tp"] == 0]
    assert sum(got[r]["aux"] for r in line) == pytest.approx(jaux, rel=1e-5)
    assert sum(got[r]["z"] for r in line) == pytest.approx(jz, rel=1e-5)
    n_rows, n_sp = plan.dp * plan.fsdp * plan.ep, plan.sp
    for r, res in enumerate(got):
        c = tmesh.coords(plan, r)
        j = ((c["dp"] * plan.fsdp + c["fsdp"]) * plan.ep + c["ep"]) * n_sp \
            + c["sp"]
        shape = res["out"].shape
        np.testing.assert_allclose(
            res["out"].numpy(), _rank_tokens(
                jout.reshape(B * S, -1), n_rows, n_sp, j).reshape(shape),
            **TOL)
        np.testing.assert_allclose(
            res["grads"]["x"].numpy(), _rank_tokens(
                grads["x"].numpy().reshape(B * S, -1), n_rows, n_sp,
                j).reshape(shape), **TOL)
        for k in (k for k in grads if k != "x"):
            np.testing.assert_allclose(
                res["grads"][k].numpy(),
                tmesh.shard(grads[k], rules[kinds[k]], plan, r).numpy(),
                **TOL)


# ---- the layout under ep ----------------------------------------------------

EP_PLANS = [dict(ep=2), dict(ep=4), dict(dp=2, ep=2), dict(fsdp=2, ep=2),
            dict(ep=2, tp=2), dict(ep=2, sp=2), dict(dp=2, fsdp=2, ep=2)]


@pytest.mark.parametrize("plan", EP_PLANS, ids=str)
def test_each_ranks_rows_and_bank_shards_are_jaxs(plan):
    """The rows shard_batch gives each rank are the rows JAX's batch
    sharding puts on its device (dp x fsdp x ep, ep minor); each rank's
    shard of every MoE leaf is the one JAX puts there, banks cut over ep,
    fsdp and tp; unshard gives each leaf back."""
    jcfg, tcfg = _configs()
    tplan = tmesh.MeshPlan(**plan)
    n = tplan.size
    jm = jmesh.make_mesh(jmesh.MeshPlan(**plan), jax.devices()[:n])
    tokens = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    placed = jax.device_put(tokens, NamedSharding(jm, jmesh.batch_spec()))
    by_device = {s.device.id: np.asarray(s.data)
                 for s in placed.addressable_shards}
    tree = jax.tree.map(np.asarray, jmoe.init_params(jcfg,
                                                     jax.random.key(1)))
    params = convert.params_from_numpy(tree, tcfg)
    specs = ttrain.param_specs(tcfg)
    jspecs = jtrain.param_specs(jcfg)
    for r in range(n):
        g = tmesh.MeshGroups(tplan, r, world=AxisGroup(None, r, n))
        tr = ttrain.Trainer.create(tcfg, tplan, device="cpu", groups=g)
        rows = tr.shard_batch(tokens).numpy()
        sp = tmesh.coords(tplan, r)["sp"]
        np.testing.assert_array_equal(
            np.array_split(rows, tplan.sp, axis=1)[sp], by_device[r])
    for name in ("we1", "we3", "we2", "router", "wq"):
        leaf = params["layers"][name]
        jleaf = jax.device_put(tree["layers"][name],
                               NamedSharding(jm, jspecs["layers"][name]))
        on = {s.device.id: np.asarray(s.data)
              for s in jleaf.addressable_shards}
        mine = [tmesh.shard(leaf, specs["layers"][name], tplan, r)
                for r in range(n)]
        for r in range(n):
            np.testing.assert_array_equal(mine[r].numpy(), on[r])
        assert torch.equal(tmesh.unshard(mine, specs["layers"][name], tplan),
                           leaf)
    dims = tmesh.split_dims(specs["layers"]["we1"], tplan)
    assert dict(dims)["ep"] == 1 and all(
        dict(dims).get(a) == d for a, d in (("fsdp", 2), ("tp", 3))
        if getattr(tplan, a) > 1)
    assert tmesh.split_dims(specs["layers"]["router"], tplan) == ()
