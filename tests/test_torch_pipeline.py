"""PyTorch port, parallel/pipeline.py on the CPU: the schedule's pure
functions (schedule_work_units, group_layers / ungroup_layers, the
divisibility errors) against JAX's; then pipeline_forward over 4 gloo
ranks at `tiny` with 4 layers (f32) against JAX's pipeline_forward on the
same MeshPlan over forced CPU devices, logits and router loss: llama pp=2
x fsdp=2, pp=2 x tp=2 interleaved (v=2, canonical stacks regrouped
inside), pp=2 x sp=2 (ring and Ulysses) and pp=4; MoE at its default
capacity factor, where microbatch pools drop tokens, pp=2 x ep=2 (GPipe
and v=2 pregrouped) and pp=2 x sp=2 (each sequence shard routes its own
tokens). A full-batch routing (the port's one-rank moe_forward) must miss
JAX's pipelined numbers; the plain microbatched version must meet them."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel import pipeline as jpipe
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu.parallel.mesh import make_mesh
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.parallel import pipeline as tpipe
from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan

torch.set_num_threads(1)

LAYERS = 4
B, S = 8, 32
# logits and router loss against JAX (f32); the planted full-batch routing
# reads 2.9e-2 in the logits
TOL = 1e-4
# name: (family, plan, microbatches, virtual_stages, pregrouped, sp_attn)
CASES = {
    "llama-pp2xfsdp2": ("llama", {"pp": 2, "fsdp": 2}, 2, 1, False, "ring"),
    "llama-pp2xtp2-v2": ("llama", {"pp": 2, "tp": 2}, 4, 2, False, "ring"),
    "llama-pp2xsp2-ring": ("llama", {"pp": 2, "sp": 2}, 2, 1, False, "ring"),
    "llama-pp2xsp2-ulysses": ("llama", {"pp": 2, "sp": 2}, 2, 1, False,
                              "ulysses"),
    "llama-pp4": ("llama", {"pp": 4}, 4, 1, False, "ring"),
    "moe-pp2xep2": ("moe", {"pp": 2, "ep": 2}, 2, 1, False, "ring"),
    "moe-pp2xep2-v2": ("moe", {"pp": 2, "ep": 2}, 2, 2, True, "ring"),
    "moe-pp2xsp2": ("moe", {"pp": 2, "sp": 2}, 2, 1, False, "ring"),
}


def _configs(family, attn="ring"):
    if family == "llama":
        j, t = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    else:
        j, t = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    j = dataclasses.replace(j, n_layers=LAYERS)
    if family == "llama":
        j = dataclasses.replace(j, sp_attn=attn)
    return j, dataclasses.replace(t, n_layers=LAYERS, sp_attn=attn)


def _trees():
    return {fam: jax.tree.map(np.asarray, (jllama if fam == "llama" else jmoe)
                              .init_params(_configs(fam)[0],
                                           jax.random.key(7)))
            for fam in ("llama", "moe")}


def _tokens():
    return np.random.default_rng(70).integers(0, 256, (B, S)).astype(
        np.int32)


def _jax_forward(name, tree, tokens):
    fam, plan, m, v, _, attn = CASES[name]
    jcfg, _ = _configs(fam, attn)
    plan = JMeshPlan(**plan)
    mesh = make_mesh(plan, jax.devices()[:plan.size])
    params = jax.tree.map(jnp.asarray, tree)
    with mesh:
        out = jax.jit(lambda p, t: jpipe.pipeline_forward(
            p, t, jcfg, mesh, n_microbatches=m, virtual_stages=v))(
                params, jnp.asarray(tokens))
    logits, router = out if fam == "moe" else (out, None)
    return np.asarray(logits), None if router is None else float(router)


def _assemble(ranks, name):
    """The global logits [B, S, V] from the last stage's ranks (each its
    rows, sequence shard and vocab shard), and every rank's router loss."""
    fam, plan, *_ = CASES[name]
    out = np.full((B, S, 256), np.nan, np.float32)
    n_sp, n_tp = plan.get("sp", 1), plan.get("tp", 1)
    sl, vl = S // n_sp, 256 // n_tp
    for r in ranks:
        got = r[name]
        if got["logits"] is None:
            continue
        c = got["coords"]
        out[got["rows"], c["sp"] * sl:(c["sp"] + 1) * sl,
            c["tp"] * vl:(c["tp"] + 1) * vl] = got["logits"].numpy()
    assert not np.isnan(out).any(), f"{name}: positions no rank returned"
    return out, [r[name]["router"] for r in ranks]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port over 4 gloo ranks (every case in one group of processes)
    while JAX compiles each case."""
    trees, tokens = _trees(), _tokens()
    ranks, failed = [], []

    def over_ranks():
        try:
            payload = []
            for name, (fam, plan, m, v, pre, attn) in CASES.items():
                payload.append(dict(
                    name=name, config=_configs(fam, attn)[1],
                    params=trees[fam], tokens=tokens, plan=plan,
                    microbatches=m, virtual_stages=v, pregrouped=pre))
            ranks.extend(workers.run(workers.pipeline_cases, payload, 4,
                                     str(tmp_path_factory.mktemp("pp"))))
        except Exception as e:         # raised again in the test process
            failed.append(e)

    thread = threading.Thread(target=over_ranks)
    thread.start()
    jax_runs = {name: _jax_forward(name, trees[CASES[name][0]], tokens)
                for name in CASES}
    thread.join()
    if failed:
        raise failed[0]
    return jax_runs, ranks, trees, tokens


def _miss(got, want):
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("name", CASES)
def test_pipeline_forward_matches_jax(runs, name):
    jax_runs, ranks, _, _ = runs
    logits, routers = _assemble(ranks, name)
    want, want_router = jax_runs[name]
    assert _miss(logits, want) <= TOL
    if CASES[name][0] == "moe":
        assert all(r == routers[0] for r in routers)   # the same everywhere
        assert routers[0] == pytest.approx(want_router, rel=TOL)


@pytest.mark.parametrize("name", ["moe-pp2xep2", "moe-pp2xsp2"])
def test_microbatch_pools_drop_and_full_batch_routing_misses_jax(runs,
                                                                 name):
    """At the default capacity the microbatch (and, under sp, sequence
    shard) pools route otherwise than the whole batch: the port's one-rank
    moe_forward (a full-batch routing, planted) misses JAX's pipelined
    logits or router loss by more than TOL, while the plain microbatched
    version, with the pipeline's pools, meets them."""
    jax_runs, _, trees, tokens = runs
    fam, plan, m, _, _, attn = CASES[name]
    _, tcfg = _configs(fam, attn)
    params = convert.params_from_numpy(trees[fam], tcfg)
    toks = torch.as_tensor(tokens).long()
    want, want_router = jax_runs[name]
    with torch.no_grad():
        full, full_router = tmoe.moe_forward(params, toks, tcfg)
        plain, plain_router = tpipe.microbatched_forward(
            params, toks, tcfg, m, seq_pools=plan.get("sp", 1))
    assert max(_miss(full.numpy(), want),
               abs(float(full_router) / want_router - 1)) > TOL
    assert _miss(plain.numpy(), want) <= TOL
    assert float(plain_router) == pytest.approx(want_router, rel=TOL)


@pytest.mark.parametrize("name", ["llama-pp2xfsdp2", "llama-pp4"])
def test_plain_microbatched_llama_is_the_forward(runs, name):
    """For llama the microbatches change no number: the plain version is
    llama_forward."""
    _, ranks, trees, tokens = runs
    _, tcfg = _configs("llama")
    params = convert.params_from_numpy(trees["llama"], tcfg)
    toks = torch.as_tensor(tokens).long()
    with torch.no_grad():
        plain = tpipe.microbatched_forward(params, toks, tcfg,
                                           CASES[name][2])
        ref = tllama.llama_forward(params, toks, tcfg)
    torch.testing.assert_close(plain, ref, rtol=1e-5, atol=1e-5)
    logits, _ = _assemble(ranks, name)
    assert _miss(logits, ref.numpy()) <= TOL


# ---- the pure functions --------------------------------------------------------

@pytest.mark.parametrize("pp, m, v", [(2, 4, 1), (4, 8, 1), (2, 4, 2),
                                      (4, 8, 2), (4, 4, 4), (8, 16, 1)])
def test_schedule_work_units_is_jaxs(pp, m, v):
    assert tpipe.schedule_work_units(pp, m, v) == jpipe.schedule_work_units(
        pp, m, v)


@pytest.mark.parametrize("pp, m, v", [(2, 2, 1), (2, 4, 2), (4, 4, 1),
                                      (4, 8, 2), (2, 2, 2)])
def test_schedule_visits_every_chunk_once_per_microbatch(pp, m, v):
    """Each stage works M*v ticks, each (lap, microbatch) once; a lap of
    stage d at tick t is what stage d + 1 works on at t + 1."""
    works = [tpipe.schedule(pp, m, v, d) for d in range(pp)]
    for d, ticks in enumerate(works):
        real = [w for w in ticks if w is not None]
        assert sorted(real) == [(lap, mb) for lap in range(v)
                                for mb in range(m)]
        if d + 1 < pp:
            for t, w in enumerate(ticks[:-1]):
                if w is not None:
                    assert works[d + 1][t + 1] == w


@pytest.mark.parametrize("pp, v", [(2, 1), (2, 2), (4, 1)])
def test_group_and_ungroup_layers_are_jaxs(pp, v):
    rng = np.random.default_rng(3)
    layers = {"wq": rng.standard_normal((8, 3, 5)).astype(np.float32),
              "attn_norm": rng.standard_normal((8, 3)).astype(np.float32)}
    got = tpipe.group_layers({k: torch.as_tensor(a) for k, a in
                              layers.items()}, pp, v)
    want = jpipe.group_layers({k: jnp.asarray(a) for k, a in layers.items()},
                              pp, v)
    for k in layers:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = tpipe.ungroup_layers(got, pp, v)
    for k in layers:
        np.testing.assert_array_equal(back[k].numpy(), layers[k])


def _error(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n_layers, b, npp, m, v, pregrouped", [
    (4, 8, 2, 2, 1, False),          # fine
    (6, 8, 4, 2, 1, False),          # layers do not divide
    (4, 3, 2, 2, 1, False),          # batch does not divide
    (8, 8, 2, 3, 2, False),          # interleaved: m over pp
    (8, 8, 2, 4, 0, False),          # v < 1
    (8, 8, 2, 4, 2, True),           # pregrouped, right lead
    (8, 8, 4, 4, 2, True),           # pregrouped, wrong lead
])
def test_divisibility_errors_are_jaxs(n_layers, b, npp, m, v, pregrouped):
    lead = (2, 2, n_layers // 4) if pregrouped else (n_layers,)
    want = _error(jpipe._check_divisible, {"wq": jnp.zeros(lead)},
                  jnp.zeros((b, 4)), npp, m, v, pregrouped)
    assert _error(tpipe._check_divisible, lead, b, npp, m, v,
                  pregrouped) == want
    if not pregrouped and v == 1 and n_layers % npp:
        with pytest.raises(ValueError, match="not divisible by pp"):
            tpipe.group_layers({"wq": torch.zeros(n_layers)}, npp, 1)
    with pytest.raises(ValueError, match="not a group_layers layout"):
        tpipe.ungroup_layers({"wq": torch.zeros(n_layers)}, npp, 3)


def test_trunk_without_pp_is_the_plain_loop():
    """JAX's pp=1 fast path: the layers in order, no ring (here an
    identity layer, as the JAX test has it)."""
    x = torch.randn(2, 16, 8)
    out, aux = tpipe.pipeline_trunk({"w": torch.zeros(1, 3, 4)}, x,
                                    lambda h, w: h, None, 2)
    torch.testing.assert_close(out, x)
    assert float(aux) == 0.0


def test_sp_without_pp_and_bad_ulysses_are_refused_as_in_jax():
    _, tcfg = _configs("llama")
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros(8, 32, dtype=torch.long)
    plan = MeshPlan(sp=2, fsdp=2)
    with pytest.raises(ValueError, match="non-pipelined"):
        tpipe.pipeline_forward(params, toks, tcfg, MeshGroups(plan, 0),
                               n_microbatches=2)
    bad = dataclasses.replace(tcfg, sp_attn="ulysses", n_heads=3)
    with pytest.raises(ValueError, match="Ulysses under pp needs n_heads 3"):
        tpipe.pipeline_forward(params, toks, bad,
                               MeshGroups(MeshPlan(pp=2, sp=2), 0),
                               n_microbatches=2)
