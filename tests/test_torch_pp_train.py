"""PyTorch port, pipeline parallelism in the Trainer on the CPU: the
Trainer over gloo ranks on `tiny` with 4 layers (f32) for 3 steps under
pp=2 x fsdp=2 (with and without per-stage remat), pp=4, dp=2 x pp=2
interleaved (v=2) and with accum_steps=2, pp=2 x sp=2 Ulysses, MoE pp=2 x
ep=2 and pp=2 x sp=2, and over 8 ranks the slow-marked JAX pipeline cases
of tests/test_parallel_more.py (pp=2 x tp=2 x fsdp=2, fsdp=2 x pp=2 x
tp=2 interleaved, MoE pp=2 x ep=2 x tp=2, pp=2 x sp=2 x tp=2 interleaved,
MoE pp=2 x sp=2 x tp=2), against the JAX Trainer on the same MeshPlan
over forced CPU devices (loss and grad norm within rel 1e-4) and against
one rank (rel 1e-5; the gathered params within 1e-5): the one-rank
Trainer for llama, the plain microbatched version
(pipeline.microbatched_loss, the pipeline's routing pools) for MoE. Then
the interleaved checkpoint: stored grouped, restored under its template
shard for shard, served ungrouped bit for bit, refused under another (pp,
v); and `train_llama --device cpu` under pp: a SIGUSR1 quiesce with a
gapless resume, and `--pp 2` resuming across plans."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import train as jtrain
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.models import moe as jmoe
from gpu_docker_api_tpu.parallel import pipeline as jpipe
from gpu_docker_api_tpu.parallel.mesh import MeshPlan as JMeshPlan
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.models import moe as tmoe
from gpu_docker_api_tpu_torch.parallel import pipeline as tpipe
from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
from gpu_docker_api_tpu_torch.workloads import serve as tserve
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl
from test_torch_fsdp_train import quiesce_and_resume, resume_across
from test_torch_sp_train import TINY, _records, _run_main

torch.set_num_threads(1)

STEPS = 3
LAYERS = 4
# name: (family, plan, train (TrainConfig fields), sp_attn)
PLANS = {
    "pp2xfsdp2": ("llama", {"pp": 2, "fsdp": 2},
                  dict(n_microbatches=2), "ring"),
    "pp2xfsdp2-noremat": ("llama", {"pp": 2, "fsdp": 2},
                          dict(n_microbatches=2, remat=False), "ring"),
    "pp4": ("llama", {"pp": 4}, dict(n_microbatches=4), "ring"),
    "dp2xpp2-v2": ("llama", {"dp": 2, "pp": 2},
                   dict(n_microbatches=2, virtual_stages=2), "ring"),
    "dp2xpp2-accum2": ("llama", {"dp": 2, "pp": 2},
                       dict(n_microbatches=2, accum_steps=2), "ring"),
    "pp2xsp2-ulysses": ("llama", {"pp": 2, "sp": 2},
                        dict(n_microbatches=2), "ulysses"),
    "moe-pp2xep2": ("moe", {"pp": 2, "ep": 2}, dict(n_microbatches=2),
                    "ring"),
    "moe-pp2xsp2": ("moe", {"pp": 2, "sp": 2}, dict(n_microbatches=2),
                    "ring"),
    # the slow-marked JAX cases (tests/test_parallel_more.py)
    "pp2xtp2xfsdp2": ("llama", {"pp": 2, "tp": 2, "fsdp": 2},
                      dict(n_microbatches=2), "ring"),
    "fsdp2xpp2xtp2-v2": ("llama", {"fsdp": 2, "pp": 2, "tp": 2},
                         dict(n_microbatches=4, virtual_stages=2), "ring"),
    "moe-pp2xep2xtp2": ("moe", {"pp": 2, "ep": 2, "tp": 2},
                        dict(n_microbatches=2), "ring"),
    "pp2xsp2xtp2-v2": ("llama", {"pp": 2, "sp": 2, "tp": 2},
                       dict(n_microbatches=2, virtual_stages=2), "ring"),
    "moe-pp2xsp2xtp2": ("moe", {"pp": 2, "sp": 2, "tp": 2},
                        dict(n_microbatches=2), "ring"),
}
CHECKPOINT = "dp2xpp2-v2"        # written grouped, [2, 2, 1, ...]


def _configs(family, attn="ring"):
    if family == "llama":
        j, t = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
        j = dataclasses.replace(j, sp_attn=attn)
    else:
        j, t = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    return (dataclasses.replace(j, n_layers=LAYERS),
            dataclasses.replace(t, n_layers=LAYERS, sp_attn=attn))


def _setup():
    trees = {fam: jax.tree.map(np.asarray,
                               (jllama if fam == "llama" else jmoe)
                               .init_params(_configs(fam)[0],
                                            jax.random.key(9)))
             for fam in ("llama", "moe")}
    batches = [np.random.default_rng(90 + i).integers(0, 256, (8, 32))
               .astype(np.int32) for i in range(STEPS)]
    return trees, batches


def _jax_run(name, tree, batches):
    fam, plan, train, attn = PLANS[name]
    jcfg, _ = _configs(fam, attn)
    plan = JMeshPlan(**plan)
    tc = jtrain.TrainConfig(**train)
    tr = jtrain.Trainer.create(jcfg, plan, tc=tc,
                               devices=jax.devices()[:plan.size])
    params = jax.tree.map(jnp.asarray, tree)
    if tc.virtual_stages > 1:
        params["layers"] = jpipe.group_layers(params["layers"], plan.pp,
                                              tc.virtual_stages)
    state = {"params": params, "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    got = []
    for toks in batches:
        state, m = tr.step(state, tr.shard_batch(jnp.asarray(toks)))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got


def _one_rank(name, tree, batches):
    """The port on one rank: the Trainer (llama: the microbatches change
    no number), or for MoE the plain microbatched version with the
    pipeline's pools."""
    fam, plan, train, attn = PLANS[name]
    _, tcfg = _configs(fam, attn)
    one = ttrain.Trainer.create(tcfg, tc=ttrain.TrainConfig(
        accum_steps=train.get("accum_steps", 1)), device="cpu")
    if fam == "moe":
        one._loss = lambda p, t: tpipe.microbatched_loss(
            p, t, tcfg, train["n_microbatches"], plan.get("sp", 1))
    state = one.state_from_params(convert.params_from_numpy(tree, tcfg))
    got = []
    for toks in batches:
        state, m = one.step(state, one.shard_batch(toks))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got, convert.params_to_numpy(state["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per plan JAX's numbers, one rank's, and the port's over its ranks
    (the plans of 4 ranks in one group of processes, those of 8 in
    another), the ranks running while JAX compiles three at a time."""
    trees, batches = _setup()
    ranks, failed = {}, []
    ckpt_dir = {}

    def over_ranks():
        try:
            for world in (4, 8):
                specs = [dict(name=name, plan=plan, sp_attn=attn,
                              remat_policy="dots",
                              accum_steps=train.get("accum_steps", 1),
                              train={k: v for k, v in train.items()
                                     if k != "accum_steps"},
                              save=name == CHECKPOINT)
                         for name, (fam, plan, train, attn) in PLANS.items()
                         if MeshPlan(**plan).size == world]
                for fam in ("llama", "moe"):
                    mine = [s for s in specs if PLANS[s["name"]][0] == fam]
                    if not mine:
                        continue
                    tmp = str(tmp_path_factory.mktemp(f"pp{world}{fam}"))
                    payload = dict(config=_configs(fam)[1],
                                   params=trees[fam], batches=batches,
                                   runs=mine)
                    for r, res in enumerate(workers.run(
                            workers.train_steps, payload, world, tmp,
                            timeout=240)):
                        for run, got in res.items():
                            ranks.setdefault(run, [None] * world)[r] = got
                    if any(s["save"] for s in mine):
                        ckpt_dir["path"] = f"{tmp}/{CHECKPOINT}-ckpt"
        except Exception as e:         # raised again in the test process
            failed.append(e)

    thread = threading.Thread(target=over_ranks)
    thread.start()
    with ThreadPoolExecutor(3) as pool:
        jax_runs = dict(zip(PLANS, pool.map(
            lambda name: _jax_run(name, trees[PLANS[name][0]], batches),
            PLANS)))
    one_rank = {name: _one_rank(name, trees[PLANS[name][0]], batches)
                for name in PLANS}
    thread.join()
    if failed:
        raise failed[0]
    return jax_runs, one_rank, ranks, ckpt_dir["path"]


@pytest.mark.parametrize("name", PLANS)
def test_pipelined_trainer_matches_jax_and_one_rank(runs, name):
    jax_runs, one_rank, ranks, _ = runs
    got = ranks[name]
    for r in got:                # every rank reports the global numbers
        assert r["losses"] == got[0]["losses"]
        assert r["grad_norms"] == got[0]["grad_norms"]
    one, one_params = one_rank[name]
    for loss, norm, (jl, jn), (ol, on) in zip(
            got[0]["losses"], got[0]["grad_norms"], jax_runs[name], one):
        assert loss == pytest.approx(jl, rel=1e-4)
        assert norm == pytest.approx(jn, rel=1e-4)
        assert loss == pytest.approx(ol, rel=1e-5)
        assert norm == pytest.approx(on, rel=1e-5)
    params = got[0]["params"]
    if PLANS[name][2].get("virtual_stages", 1) > 1:
        plan = PLANS[name][1]
        assert params["layers"]["wq"].shape[:3] == (2, plan["pp"],
                                                    LAYERS // 4)
        params = dict(params, layers={
            k: a.reshape(LAYERS, *a.shape[3:])
            for k, a in params["layers"].items()})
    # held as tests/test_torch_fsdp_train.py holds them: Adam may flip a
    # near-zero gradient's sign between two summation orders (up to ~lr a
    # step); almost every element agrees to 1e-5
    lr = ttrain.TrainConfig().learning_rate
    diffs = []
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(one_params)):
        assert a.shape == b.shape
        diffs.append(np.abs(a - b).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * lr * STEPS
    assert np.mean(diffs <= 1e-5) >= 0.999


def _pp_trainer(rank=0, name=CHECKPOINT):
    fam, plan, train, attn = PLANS[name]
    plan = MeshPlan(**plan)
    return ttrain.Trainer.create(
        _configs(fam, attn)[1], plan, tc=ttrain.TrainConfig(**train),
        device="cpu", groups=MeshGroups(plan, rank))


def test_interleaved_checkpoint_is_grouped_and_restores_shard_for_shard(
        runs):
    """The gathered checkpoint of a v=2 run holds its layers grouped [v,
    pp, Lc, ...]; restored under the run's template each rank's shard of
    it is, bit for bit, what the rank held."""
    _, _, ranks, path = runs
    tr = _pp_trainer()
    state, step = ttrain.restore_checkpoint(path, tr.abstract_state())
    assert step == STEPS and state["opt_state"]["count"] == STEPS
    assert tuple(state["params"]["layers"]["wq"].shape[:3]) == (2, 2, 1)
    for r, got in enumerate(ranks[CHECKPOINT]):
        mine = _pp_trainer(r).shard_state(state)["params"]
        for (path_, a), (_, b) in zip(
                ttrain.tree_leaves(ttrain.tree_map_named(
                    lambda p, t: (p, t), mine)),
                ttrain.tree_leaves(ttrain.tree_map_named(
                    lambda p, t: (p, t), got["shards"]))):
            assert torch.equal(a.detach(), b), f"rank {r} {path_}"


def test_serve_ungroups_an_interleaved_checkpoint(runs):
    """serve's loaders recognise the grouped layout before the template
    check: the served params are the checkpoint's, ungrouped, bit for
    bit, in the canonical [L, ...] layout of the one-rank template."""
    _, _, _, path = runs
    fam, _, _, attn = PLANS[CHECKPOINT]
    one = ttrain.Trainer.create(_configs(fam, attn)[1], device="cpu")
    state, _ = ttrain.restore_checkpoint(path)
    want = dict(state["params"], layers=tpipe.ungroup_layers(
        state["params"]["layers"], 2, 2))
    for got in (tserve._load_params(one, path),
                tserve._restore_params(one, path, "cpu")[0]):
        ttrain.check_template(got, one.abstract_state()["params"])
        for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(want)):
            assert torch.equal(a.detach(), b.detach())
    with pytest.raises(ValueError, match="not a group_layers layout"):
        tpipe.ungroup_layers(state["params"]["layers"], 4, 1)


@pytest.mark.parametrize("plan, train", [
    ({"pp": 2}, {}),                                  # canonical, v=1
    ({"pp": 4}, {}),
    ({"pp": 2, "fsdp": 2}, {"virtual_stages": 1}),
    ({}, {}),                                         # one rank
])
def test_resume_under_another_pp_or_v_fails_loudly(runs, plan, train):
    """A grouped checkpoint does not match another (pp, v)'s template: the
    restore raises (train_llama lets it through), as the JAX workload's
    orbax restore does, rather than re-initialising."""
    _, _, _, path = runs
    fam, _, _, attn = PLANS[CHECKPOINT]
    mplan = MeshPlan(**plan)
    tr = ttrain.Trainer.create(
        _configs(fam, attn)[1], mplan, tc=ttrain.TrainConfig(
            n_microbatches=2, **train), device="cpu",
        groups=MeshGroups(mplan, 0) if mplan.size > 1 else None)
    with pytest.raises(ValueError, match="checkpoint layers"):
        ttrain.restore_checkpoint(path, tr.abstract_state())


def test_train_llama_surfaces_a_template_mismatch(tmp_path, monkeypatch):
    """train_llama's resume catches only a missing checkpoint: a mismatch
    fails the run, with no step taken."""
    import signal
    monkeypatch.setattr(signal, "signal", lambda *args: None)

    def mismatch(*args, **kwargs):
        raise ValueError("checkpoint layers.wq: (2, 2, 1, 64, 64)")
    monkeypatch.setattr(ttrain, "restore_checkpoint", mismatch)
    with pytest.raises(ValueError, match="checkpoint layers.wq"):
        ttl.main(TINY + ["--steps", "1", "--workdir", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()


# ---- train_llama under pp ---------------------------------------------------

def test_pp2_quiesce_parks_every_rank_and_resumes_gapless(tmp_path):
    """quiesce_and_resume under {"pp": 2}, two microbatches of one row."""
    quiesce_and_resume(tmp_path, '{"pp": 2}', ["--microbatches", "2"])


def test_pp2_flag_checkpoint_resumes_across_plans(tmp_path):
    """--pp 2 (the un-planned launch on --device cpu), then one rank, then
    {"pp": 2} again: resume_across, the losses of one uninterrupted
    one-rank run."""
    resume_across(tmp_path, ['{"pp": 2}', "", '{"pp": 2}'],
                  ["--microbatches", "2"])
    wd = str(tmp_path / "cli")
    base = ["--device", "cpu", "--config", "tiny", "--batch", "4", "--seq",
            "16", "--checkpoint-every", "1", "--microbatches", "2",
            "--workdir", wd]
    _run_main(base + ["--pp", "2", "--steps", "2"])
    _run_main(base + ["--pp", "2", "--steps", "3"])
    steps, _ = _records(wd)
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(r["devices"] == 2 and r["plan"] == str(MeshPlan(pp=2))
               for r in steps)
    want, _ = _records(str(tmp_path / "one"))
    assert [r["loss"] for r in steps] == pytest.approx(
        [r["loss"] for r in want[:3]], rel=1e-5)


@pytest.mark.parametrize("argv, want", [
    (["--pp", "2"], MeshPlan(pp=2)),
    (["--pp", "2", "--tp", "2"], MeshPlan(pp=2, tp=2)),
    (["--pp", "2", "--sp", "2", "--ep", "2"], MeshPlan(pp=2, ep=2, sp=2)),
])
def test_unplanned_cpu_launch_takes_pp(argv, want):
    """On --device cpu the un-planned plan is what the flags ask, pp
    included; over n cards it is JAX's MeshPlan.auto(..., pp=)."""
    args = ttl._parser().parse_args(["--device", "cpu", *argv])
    assert ttl._unplanned(args) == want
    assert ttl.unplanned_plan(8, 0, 1, pp=2) == MeshPlan(pp=2, tp=4)
    assert ttl.unplanned_plan(8, 2, 1, pp=2) == MeshPlan(fsdp=2, pp=2, tp=2)
