"""PyTorch port, the tensor-parallel pieces against the JAX package and
against one process: head_axis_for, best_tp_for, logits_spec and the
un-planned launch's plan (train_llama.unplanned_plan) against JAX's; and
over two gloo ranks copy_to_group, reduce_from_group (f32 and bf16), the
vocab-parallel cross-entropy and the vocab-parallel embedding, value and
gradient, against the one-process computation on the whole tensors."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_sp_workers as workers
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.parallel import mesh as jmesh
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.parallel import mesh as tmesh
from gpu_docker_api_tpu_torch.workloads import train_llama as ttl

torch.set_num_threads(1)

CONFIGS = ("tiny", "llama_mini", "llama_250m", "llama_1b", "llama3_8b",
           "mistral_7b")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_head_axis_for_is_the_jax_choice(name, tp):
    jcfg = getattr(jllama.LlamaConfig, name)()
    jm = jmesh.make_mesh(jmesh.MeshPlan(tp=tp), jax.devices()[:tp])
    want = jmesh.head_axis_for(jm, jcfg.n_heads, jcfg.n_kv_heads)
    assert tmesh.head_axis_for(tp, jcfg.n_heads, jcfg.n_kv_heads) == want


def test_best_tp_for_and_logits_spec_are_the_jax_ones():
    for n in range(0, 33):
        for max_tp in (1, 2, 4, 8, 16):
            assert tmesh.best_tp_for(n, max_tp) == jmesh.best_tp_for(
                n, max_tp)
    assert tmesh.logits_spec() == (tuple(jmesh.BATCH_AXES), "sp", "tp")
    assert tuple(jmesh.logits_spec()) == (jmesh.BATCH_AXES, "sp", "tp")


def _jax_unplanned(n_dev, tp, sp):
    """gpu_docker_api_tpu/workloads/train_llama.py's plan without
    TDAPI_MESH_PLAN (pp = ep = 1), as a dict, or the error it raises."""
    fixed = sp
    tp = tp or jmesh.best_tp_for(n_dev // fixed if n_dev % fixed == 0
                                 else 1)
    try:
        plan = jmesh.MeshPlan.auto(n_dev, tp=tp, sp=sp)
    except ValueError as e:
        return str(e)
    return {a: getattr(plan, a) for a in jmesh.AXES}


@pytest.mark.parametrize("tp, sp", [(0, 1), (0, 2), (1, 1), (2, 1), (4, 1),
                                    (2, 2), (0, 4)])
def test_unplanned_plan_is_the_jax_choice(tp, sp):
    for n_dev in range(1, 9):
        want = _jax_unplanned(n_dev, tp, sp)
        try:
            plan = ttl.unplanned_plan(n_dev, tp, sp)
        except ValueError as e:
            assert str(e) == want
            continue
        assert {a: getattr(plan, a) for a in tmesh.AXES} == want


def test_unplanned_plan_on_the_cpu_is_what_the_flags_ask():
    """--device cpu has no device count to fill: (--tp or 1) * --sp."""
    args = ttl._parser().parse_args
    assert ttl._unplanned(args(["--device", "cpu"])) == tmesh.MeshPlan()
    assert ttl._unplanned(args(["--device", "cpu", "--tp", "2"])) == \
        tmesh.MeshPlan(tp=2)
    assert ttl._unplanned(args(["--device", "cpu", "--tp", "2", "--sp",
                                "2"])) == tmesh.MeshPlan(tp=2, sp=2)
    assert ttl._unplanned(args(["--device", "cpu", "--sp", "2"])) == \
        tmesh.MeshPlan(sp=2)


def test_tp_collectives_over_two_ranks_equal_one_process(tmp_path):
    """Over 2 gloo ranks: copy_to_group is the identity whose gradient is
    the sum of the ranks' cotangents; reduce_from_group is the f32 sum of
    the ranks' parts cast back (bf16 too) whose gradient is the
    cotangent; the vocab-parallel log-likelihood of each rank's vocab
    chunk is the one-process log_softmax's on every rank, its gradient
    the rank's chunk of the whole one; the vocab-parallel lookup is
    F.embedding's, bit for bit, its gradient the rank's chunk of the
    whole one."""
    rng = np.random.default_rng(0)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    v = 48
    targets = rng.integers(0, v, (3, 5))
    targets[0, :3] = [0, v // 2 - 1, v // 2]          # the chunk edges
    spec = {"x": rand(3, 4), "w": [rand(3, 4) for _ in range(2)],
            "parts": [[rand(2, 6) for _ in range(2)],
                      [torch.from_numpy(rand(2, 6)).bfloat16()
                       for _ in range(2)]],
            "cots": [rand(2, 6), torch.from_numpy(rand(2, 6)).bfloat16()],
            "logits": 4 * rand(3, 5, v), "targets": targets,
            "ll_cot": rand(3, 5), "embed": rand(v, 8),
            "tokens": rng.integers(0, v, (2, 7)), "embed_cot": rand(2, 7, 8)}
    ranks = workers.run(workers.tp_cases, spec, 2, str(tmp_path))

    x = torch.from_numpy(spec["x"])
    logits = torch.from_numpy(spec["logits"]).requires_grad_(True)
    ll = ttrain._log_likelihood(logits, torch.from_numpy(targets))
    ll_grad, = torch.autograd.grad(ll, logits,
                                   torch.from_numpy(spec["ll_cot"]))
    embed = torch.from_numpy(spec["embed"]).requires_grad_(True)
    rows = F.embedding(torch.from_numpy(spec["tokens"]), embed)
    embed_grad, = torch.autograd.grad(rows, embed,
                                      torch.from_numpy(spec["embed_cot"]))
    for r, got in enumerate(ranks):
        assert torch.equal(got["copy"], x)
        assert torch.allclose(got["copy_grad"], torch.from_numpy(
            spec["w"][0] + spec["w"][1]), rtol=0, atol=1e-6)
        for parts, cot, s, g in zip(spec["parts"], spec["cots"],
                                    got["sums"], got["reduce_grads"]):
            parts = [torch.as_tensor(p) for p in parts]
            want = (parts[0].float() + parts[1].float()).to(parts[0].dtype)
            assert s.dtype == parts[0].dtype and torch.equal(s, want)
            assert torch.equal(g, torch.as_tensor(cot))
        torch.testing.assert_close(got["ll"], ll.detach(), rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got["ll_grad"],
                                   ll_grad.chunk(2, dim=-1)[r],
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(got["rows"], rows.detach())
        assert torch.equal(got["embed_grad"], embed_grad.chunk(2, dim=0)[r])
