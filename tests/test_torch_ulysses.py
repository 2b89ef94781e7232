"""PyTorch port, parallel/ulysses.py: Ulysses attention over sp = 2 and 4
gloo ranks on the CPU against the JAX ulysses_attention on
make_mesh(MeshPlan(sp=n)), from the same numpy inputs made with a seed:
each rank's output and q/k/v gradient shards, put back together, within
2e-5 and 1e-4 of the JAX function's, every gradient finite. Covers the KV
head replication of GQA (Hkv below sp) and the refusal of heads that do
not divide over sp (twins of tests/test_parallel_more.py:212-245). All
cases of one sp size run in one spawned group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu.parallel import ulysses as julysses
from gpu_docker_api_tpu.parallel.mesh import MeshPlan, make_mesh
from gpu_docker_api_tpu_torch.parallel import comm, ulysses

torch.set_num_threads(1)

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
B, S, D = 2, 64, 16

# name: (q heads, kv heads, causal, window)
CASES = {
    "mha": (8, 8, True, 0),
    "gqa": (8, 4, True, 0),
    "gqa-replicated": (8, 2, True, 0),      # Hkv < sp at sp=4
    "mqa-replicated": (8, 1, True, 0),
    "full": (8, 4, False, 0),
    "window": (8, 4, True, 20),
}


def _inputs(name):
    h, hkv, _, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, S, h, D), f(B, S, hkv, D), f(B, S, hkv, D), f(B, S, h, D)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{sp: [each rank's results]}: one group per sp size, every case."""
    got = {}

    def results(n):
        if n not in got:
            payload = []
            for name, (_, _, causal, window) in CASES.items():
                q, k, v, do = _inputs(name)
                payload.append(dict(name=name, fn="ulysses", q=q, k=k, v=v,
                                    do=do, causal=causal, window=window,
                                    impl="auto"))
            got[n] = workers.run(workers.attention_cases, payload, n,
                                 str(tmp_path_factory.mktemp(f"uly{n}")))
        return got[n]
    return results


def _jax_ulysses(name, n):
    _, _, causal, window = CASES[name]
    q, k, v, do = _inputs(name)
    mesh = make_mesh(MeshPlan(sp=n), jax.devices()[:n])

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: julysses.ulysses_attention(
            q, k, v, mesh, causal=causal, window=window), q, k, v)
        return out, vjp(do)

    with mesh:
        out, grads = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_matches_jax(ranks, name, n):
    res = [r[name] for r in ranks(n)]
    out = torch.cat([r["out"] for r in res], dim=1).numpy()
    grads = [torch.cat([r["grads"][i] for r in res], dim=1)
             for i in range(3)]
    jout, jgrads = _jax_ulysses(name, n)
    np.testing.assert_allclose(out, jout, atol=OUT_TOL, rtol=OUT_TOL)
    for g, jg in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    assert all(r["hops"] == 0 for r in res)


def test_ulysses_rejects_indivisible_heads():
    """6 heads over sp 4: both packages refuse before any collective."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 6, 16)).astype(np.float32)
    mesh = make_mesh(MeshPlan(sp=4), jax.devices()[:4])
    with pytest.raises(ValueError, match="divide") as jerr:
        julysses.ulysses_attention(*map(jnp.asarray, (q, q, q)), mesh)
    tq = torch.from_numpy(q[:, :16])            # rank 0's shard
    with pytest.raises(ValueError, match="divide") as terr:
        ulysses.ulysses_attention(tq, tq, tq, comm.SPGroup(None, 0, 4))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("hkv, tp_n", [(4, 2), (3, 1)])
def test_ulysses_under_tp_rejects_indivisible_local_heads(hkv, tp_n):
    """8 q heads over tp=2 x sp=3: with 4 kv heads the heads split over tp
    and (8/2) % 3 is refused naming tp=2; with 3 kv heads they do not
    (the head-gather fallback) and 8 % 3 is refused naming tp=1. Both
    packages refuse alike."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 48, 8, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 48, hkv, 16)).astype(np.float32)
    mesh = make_mesh(MeshPlan(tp=2, sp=3), jax.devices()[:6])
    with pytest.raises(ValueError, match="divide") as jerr:
        julysses.ulysses_attention(*map(jnp.asarray, (q, kv, kv)), mesh)
    heads = 8 // tp_n                        # the heads a tp rank holds
    tq = torch.from_numpy(q[:, :16, :heads])
    tkv = torch.from_numpy(kv[:, :16, :hkv // tp_n])
    with pytest.raises(ValueError, match="divide") as terr:
        ulysses.ulysses_attention(tq, tkv, tkv, comm.SPGroup(None, 0, 3),
                                  tp=tp_n)
    assert str(terr.value) == str(jerr.value)


def test_one_rank_is_the_local_attention():
    from gpu_docker_api_tpu_torch.ops import attention as tatt

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("gqa"))
    want = tatt.attention(q, k, v, causal=False)
    for sp in (None, comm.SPGroup(group=None, rank=0, size=1)):
        assert torch.equal(
            ulysses.ulysses_attention(q, k, v, sp, causal=False), want)
