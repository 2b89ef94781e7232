"""PyTorch port, distributed.py and the refusals of what is not yet ported:
cluster_spec_from_env against the JAX function on the same env dicts; two
gloo ranks formed from the control plane's contract on 127.0.0.1; the
single-host launcher failing fast when a rank dies; and the workload's
refusals (--sp N without N cards, a multi-worker grant), and the launches
that MoE, ep and pp over ranks now take."""

import multiprocessing as mp
import os
import time

import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu import distributed as jdist
from gpu_docker_api_tpu_torch import distributed as tdist
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--config", "tiny", "--batch", "2", "--seq", "16",
        "--steps", "1"]


@pytest.mark.parametrize("env", [
    {},
    {"TPU_WORKER_HOSTNAMES": "w0"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1", "TPU_WORKER_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": "w0,,w1,w2", "TPU_PROCESS_PORT": "9000"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1", "TPU_PROCESS_PORT": "bad"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1",
     "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1", "TPU_WORKER_ID": "x"},
])
def test_cluster_spec_equals_the_jax_parse(env):
    def parse(mod):
        try:
            return "spec", mod.cluster_spec_from_env(env)
        except ValueError as e:
            return "error", str(e)
    assert parse(tdist) == parse(jdist)
    assert tdist.PORT_OFFSET == jdist.PORT_OFFSET


def test_two_gloo_ranks_form_from_the_contract(tmp_path):
    """Each worker knows only the env the control plane stamps; the
    coordinator is TPU_PROCESS_PORT + PORT_OFFSET on the first host."""
    port = tdist.free_port()
    envs = [{"TPU_WORKER_HOSTNAMES": "127.0.0.1,127.0.0.1",
             "TPU_WORKER_ID": str(r),
             "TPU_PROCESS_PORT": str(port - tdist.PORT_OFFSET)}
            for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.contract_rank,
                         args=(r, envs[r], str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["spec"] == {"coordinator": f"127.0.0.1:{port}",
                               "num_processes": 2, "process_id": r}
        assert got["again"] == got["spec"]          # idempotent
        assert got["sum"] == 3.0 and got["backend"] == "gloo"
    assert tdist.backend_for("cuda") == "nccl"
    assert tdist.backend_for(torch.device("cuda", 1)) == "nccl"
    assert tdist.backend_for("cpu") == "gloo"


def test_launcher_fails_fast_when_a_rank_dies(tmp_path):
    """Rank 1 exits 3 while rank 0 sleeps for 10 min: the launch raises
    within seconds and leaves no rank running."""
    before = set(mp.active_children())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 3"):
        tdist.launch(workers.die_on_rank_1, ("", str(tmp_path)), 2, "gloo",
                     init_method=f"file://{tmp_path}/rdzv", timeout=120)
    assert time.monotonic() - t0 < 60
    assert set(mp.active_children()) <= before


def test_launcher_times_out_and_stops_its_ranks(tmp_path):
    before = set(mp.active_children())
    with pytest.raises(TimeoutError, match="still running"):
        tdist.launch(workers.die_on_rank_1, ("", str(tmp_path)), 1, "gloo",
                     init_method=f"file://{tmp_path}/rdzv", timeout=0.01)
    assert set(mp.active_children()) <= before


def test_sp_without_the_cards_raises(tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError,
                       match=f"--sp 2 needs 2 CUDA devices, sees {n}"):
        ttl.main(["--config", "tiny", "--sp", "2", "--workdir",
                  str(tmp_path)])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("extra, env", [
    (["--sp", "2"], {"TPU_WORKER_HOSTNAMES": "w0,w1"}),
])
def test_unported_axes_and_moe_over_ranks_are_refused(tmp_path, monkeypatch,
                                                      extra, env):
    """A multi-worker grant is refused (every mesh axis is ported:
    test_pp_plans_are_built_and_accepted)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttl.main(TINY + ["--workdir", str(tmp_path)] + extra)
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("extra, env, plan", [
    ([], {"TDAPI_MESH_PLAN": '{"tp": 2, "pp": 2}'}, dict(pp=2, tp=2)),
    (["--pp", "2"], {}, dict(pp=2)),
    ([], {"TDAPI_MESH_PLAN": '{"pp": 2, "ep": 2}'}, dict(pp=2, ep=2)),
    (["--virtual-stages", "2"], {}, {}),
    (["--family", "moe", "--pp", "2"], {}, dict(pp=2)),
    (["--family", "moe"], {"TDAPI_MESH_PLAN": '{"dp": 2, "pp": 2}'},
     dict(dp=2, pp=2)),
    ([], {"TDAPI_MESH_PLAN": '{"ep": 2, "pp": 2, "tp": 2}'},
     dict(pp=2, ep=2, tp=2)),
    (["--family", "moe", "--virtual-stages", "2"], {}, {}),
])
def test_pp_plans_are_built_and_accepted(tmp_path, monkeypatch, extra, env,
                                         plan):
    """What was refused before pp was ported now reaches the run, with the
    plan asked for (--virtual-stages without --pp is one rank, as in JAX,
    which reads it only under pp), and Trainer.create accepts it with the
    flags' microbatches and virtual stages (the runs themselves:
    test_torch_pp_train.py)."""
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer, TrainConfig
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    started = []
    monkeypatch.setattr(ttl, "_launch",
                        lambda args, argv, p: started.append((args, p)) or 0)
    monkeypatch.setattr(ttl, "_run", lambda args, config, p, device:
                        started.append((args, p)) or 0)
    assert ttl.main(TINY + ["--workdir", str(tmp_path)] + extra) == 0
    (args, got), = started
    assert got == MeshPlan(**plan)
    trainer = Trainer.create(
        named_config(args.family, args.config), got,
        tc=TrainConfig(n_microbatches=args.microbatches,
                       virtual_stages=args.virtual_stages),
        device="cpu", groups=MeshGroups(got, 0) if got.size > 1 else None)
    assert trainer.pipelined == (got.pp > 1)
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("extra, env, plan", [
    (["--ep", "2"], {}, dict(ep=2)),
    (["--family", "moe", "--sp", "2"], {}, dict(sp=2)),
    (["--family", "moe"], {"TDAPI_MESH_PLAN": '{"dp": 2}'}, dict(dp=2)),
    ([], {"TDAPI_MESH_PLAN": '{"ep": 2, "tp": 2}'}, dict(ep=2, tp=2)),
    (["--family", "moe", "--tp", "2"], {}, dict(tp=2)),
])
def test_moe_and_ep_over_ranks_start(tmp_path, monkeypatch, extra, env,
                                     plan):
    """What was refused before ep and MoE over ranks were ported now
    reaches the launch of its ranks, with the plan asked for (the runs
    themselves: test_torch_moe_ranks_train.py)."""
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshPlan
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launched = []
    monkeypatch.setattr(ttl, "_launch",
                        lambda args, argv, p: launched.append(p) or 0)
    assert ttl.main(TINY + ["--workdir", str(tmp_path)] + extra) == 0
    assert launched == [MeshPlan(**plan)]


def test_trainer_refuses_a_plan_without_its_group():
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.parallel.comm import AxisGroup
    from gpu_docker_api_tpu_torch.parallel.mesh import MeshGroups, MeshPlan
    from gpu_docker_api_tpu_torch.train import Trainer

    tiny = named_config("llama", "tiny")
    for plan in (MeshPlan(sp=2), MeshPlan(dp=2), MeshPlan(fsdp=2),
                 MeshPlan(dp=2, fsdp=2), MeshPlan(tp=2),
                 MeshPlan(fsdp=2, tp=2)):
        with pytest.raises(ValueError, match=f"needs the groups of its "
                                             f"{plan.size} ranks"):
            Trainer.create(tiny, plan, device="cpu")
    # groups formed for another plan
    two = AxisGroup(None, 0, 2)
    with pytest.raises(ValueError, match="needs the groups of its 4 ranks"):
        Trainer.create(tiny, MeshPlan(sp=4), device="cpu",
                       groups=MeshGroups(MeshPlan(sp=2), 0, sp=two,
                                         world=two))
    # MoE over ranks is ported, and so is pp, which needs its groups too
    moe = named_config("moe", "tiny")
    assert Trainer.create(moe, MeshPlan(dp=2), device="cpu",
                          groups=MeshGroups(MeshPlan(dp=2), 0, dp=two,
                                            world=two))
    with pytest.raises(ValueError, match="needs the groups of its 2 ranks"):
        Trainer.create(moe, MeshPlan(pp=2), device="cpu")
    assert Trainer.create(moe, MeshPlan(pp=2), device="cpu",
                          groups=MeshGroups(MeshPlan(pp=2), 0, pp=two,
                                            world=two)).pipelined
