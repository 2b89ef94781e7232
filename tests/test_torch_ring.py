"""PyTorch port, parallel/ring.py: ring attention over sp = 2 and 4 gloo
ranks on the CPU against the JAX ring_attention on make_mesh(MeshPlan(sp=n))
(eight virtual CPU devices), from the same numpy inputs made with a seed.

Each rank holds its S/sp shard; the shards of its output and of its q/k/v
gradients are put back together and held to the JAX function's global
output and gradients: within 2e-5 and 1e-4, every gradient finite. The
port's flash body (the kernels' plain versions on CPU tensors) and its
einsum body (impl="xla") are both held to the JAX einsum body, which JAX
runs off the TPU. All cases of one sp size run in one spawned group."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from gpu_docker_api_tpu.parallel import ring as jring
from gpu_docker_api_tpu.parallel.mesh import MeshPlan, make_mesh

torch.set_num_threads(1)

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
B, S, H, D = 2, 64, 4, 16

# name: (impl, causal, window, kv heads)
CASES = {
    "flash-causal": ("auto", True, 0, 2),
    "flash-full": ("flash", False, 0, 2),
    "flash-causal-mha": ("auto_grad", True, 0, 4),
    "einsum-causal": ("xla", True, 0, 2),
    "einsum-full": ("xla", False, 0, 1),
    "flash-window-10": ("auto", True, 10, 2),
    "flash-window-20": ("auto", True, 20, 2),
    "flash-window-40": ("auto", True, 40, 2),
    "einsum-window-20": ("xla", True, 20, 2),
}


def _inputs(name):
    hkv = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, S, H, D), f(B, S, hkv, D), f(B, S, hkv, D), f(B, S, H, D)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{sp: [each rank's results]}: one group per sp size, every case."""
    got = {}

    def results(n):
        if n not in got:
            payload = []
            for name, (impl, causal, window, _) in CASES.items():
                q, k, v, do = _inputs(name)
                payload.append(dict(name=name, fn="ring", q=q, k=k, v=v,
                                    do=do, causal=causal, window=window,
                                    impl=impl))
            got[n] = workers.run(workers.attention_cases, payload, n,
                                 str(tmp_path_factory.mktemp(f"ring{n}")))
        return got[n]
    return results


def _jax_ring(name, n):
    impl, causal, window, _ = CASES[name]
    q, k, v, do = _inputs(name)
    mesh = make_mesh(MeshPlan(sp=n), jax.devices()[:n])

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: jring.ring_attention(
                q, k, v, mesh, causal=causal,
                impl="xla" if impl == "xla" else "auto", window=window),
            q, k, v)
        return out, vjp(do)

    with mesh:
        out, grads = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(ranks, name, n):
    res = [r[name] for r in ranks(n)]
    out = torch.cat([r["out"] for r in res], dim=1).numpy()
    grads = [torch.cat([r["grads"][i] for r in res], dim=1)
             for i in range(3)]
    jout, jgrads = _jax_ring(name, n)
    np.testing.assert_allclose(out, jout, atol=OUT_TOL, rtol=OUT_TOL)
    for g, jg in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    # hops: n - 1, or min(n - 1, ceil((window - 1) / s_loc)) (ring.py:190)
    window = CASES[name][2]
    want = (min(n - 1, math.ceil((window - 1) / (S // n))) if window
            else n - 1)
    assert [r["hops"] for r in res] == [want] * n


def test_one_rank_is_the_local_attention():
    """sp None or of size 1: the local attention() (JAX ring.py:62-64)."""
    from gpu_docker_api_tpu_torch.ops import attention as tatt
    from gpu_docker_api_tpu_torch.parallel import comm, ring

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("flash-causal"))
    want = tatt.attention(q, k, v, window=20)
    for sp in (None, comm.SPGroup(group=None, rank=0, size=1)):
        assert torch.equal(ring.ring_attention(q, k, v, sp, window=20), want)
    with pytest.raises(ValueError, match="impl"):
        ring.ring_body_auto(q, k, v, sp=comm.SPGroup(None, 0, 2),
                            causal=True, impl="pallas")
