"""PyTorch port, ops/attention.py: the same numpy inputs through the JAX
package and the port, on the CPU.

- reference_attention (values and grads) against the JAX reference;
- the port's flash_attention / flash_attention_lse (on CPU tensors: the
  plain versions of the three kernels inside the autograd Functions)
  against the JAX Pallas kernels run in interpret mode, for out, lse and
  dq/dk/dv (S=128, blocks of 64, f32, tolerance 2e-3 as
  tests/test_flash_bwd.py);
- the wrappers' input checks and the dispatcher.
The CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu_torch.ops import attention as tatt

# importlib: the JAX ops package re-exports an `attention` function that
# shadows the submodule attribute
jatt = importlib.import_module("gpu_docker_api_tpu.ops.attention")

torch.set_num_threads(1)

REF_TOL = 1e-5     # f32, same einsum/softmax math in both
FLASH_TOL = 2e-3   # f32, blockwise kernel vs full-matrix math


def _inputs(b, s, h, hkv, d, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = sk or s
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    return (f(b, s, h, d), f(b, sk, hkv, d), f(b, sk, hkv, d),
            f(b, s, h, d), f(b, h, s))


def _t(x):
    return torch.from_numpy(np.array(x)).requires_grad_(True)


REF_CASES = [
    dict(b=2, s=16, h=4, hkv=4, d=8, causal=True),              # MHA causal
    dict(b=2, s=16, h=4, hkv=2, d=8, causal=True),              # GQA causal
    dict(b=1, s=24, h=4, hkv=1, d=16, causal=True, window=5),   # window
    dict(b=1, s=16, h=4, hkv=2, d=8, causal=False),             # full
    dict(b=1, s=12, h=2, hkv=1, d=8, causal=False, sk=20),      # s_q != s_k
    dict(b=1, s=20, h=2, hkv=2, d=8, causal=True, sk=12),       # causal, s_q > s_k
]


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_attention_matches_jax(case):
    case = dict(case)
    causal, window = case.pop("causal"), case.pop("window", 0)
    q, k, v, cot, _ = _inputs(**case)

    def jloss(q, k, v):
        return jnp.sum(jatt.reference_attention(q, k, v, causal=causal,
                                                window=window) * cot)

    jout = jatt.reference_attention(q, k, v, causal=causal, window=window)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = _t(q), _t(k), _t(v)
    tout = tatt.reference_attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=REF_TOL, rtol=REF_TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=REF_TOL,
                                   rtol=REF_TOL, err_msg=name)


FLASH_CASES = [
    dict(b=1, s=128, h=4, hkv=2, d=32, causal=True),             # GQA causal
    dict(b=1, s=128, h=4, hkv=4, d=16, causal=False),            # full
    dict(b=1, s=128, h=4, hkv=2, d=32, causal=True, window=40),  # window
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax_kernels(case):
    case = dict(case)
    causal, window = case.pop("causal"), case.pop("window", 0)
    q, k, v, cot, _ = _inputs(**case, seed=1)

    def jloss(q, k, v):
        out = jatt.flash_attention(q, k, v, causal=causal, blk_q=64,
                                   blk_k=64, interpret=True, window=window)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tout = tatt.flash_attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                   atol=FLASH_TOL, rtol=FLASH_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("window", [0, 40])
def test_flash_attention_lse_matches_jax_kernels(window):
    """Both outputs and the grads through both (the dlse term)."""
    q, k, v, cot, dl = _inputs(b=1, s=128, h=4, hkv=2, d=32, seed=2)

    def jloss(q, k, v):
        out, lse = jatt.flash_attention_lse(q, k, v, causal=True, blk_q=64,
                                            blk_k=64, interpret=True,
                                            window=window)
        return jnp.sum(out * cot) + jnp.sum(lse * dl), (out, lse)

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tout, tlse = tatt.flash_attention_lse(tq, tk, tv, causal=True,
                                          window=window)
    loss = (tout * torch.from_numpy(cot)).sum() + (tlse * torch.from_numpy(
        dl)).sum()
    tgrads = torch.autograd.grad(loss, (tq, tk, tv))
    assert tlse.shape == (1, 4, 128) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                   atol=FLASH_TOL, rtol=FLASH_TOL,
                                   err_msg=name)


def test_plain_versions_are_the_reference_gradients():
    """The three plain versions (what the kernels are held against) equal
    autograd through reference_attention + logsumexp, dlse included."""
    q, k, v, cot, dl = _inputs(b=2, s=40, h=4, hkv=2, d=16, seed=3)
    tq, tk, tv = _t(q), _t(k), _t(v)
    ref = tatt.reference_attention(tq, tk, tv, causal=True, window=9)
    lse_ref = torch.logsumexp(tatt._scaled_scores(tq, tk, True, 9), dim=-1)
    cot_t, dl_t = torch.from_numpy(cot), torch.from_numpy(dl)
    grads = torch.autograd.grad((ref * cot_t).sum() + (lse_ref * dl_t).sum(),
                                (tq, tk, tv))
    with torch.no_grad():
        o, lse = tatt.flash_fwd_plain(tq, tk, tv, True, 9)
        dq = tatt.flash_bwd_dq_plain(tq, tk, tv, o, cot_t, lse, True, 9, dl_t)
        dk, dv = tatt.flash_bwd_dkv_plain(tq, tk, tv, o, cot_t, lse, True, 9,
                                          dl_t)
    torch.testing.assert_close(o, ref.detach(), atol=REF_TOL, rtol=REF_TOL)
    torch.testing.assert_close(lse, lse_ref.detach(), atol=REF_TOL,
                               rtol=REF_TOL)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, want, atol=REF_TOL, rtol=REF_TOL)


def test_all_masked_rows_are_zero_with_finite_lse():
    """A row that sees no key (s_q > s_k under a window) gives out 0 and
    lse = log(1e-30), as the TPU kernel's guard does; grads stay finite."""
    q, k, v, cot, _ = _inputs(b=1, s=8, h=2, hkv=1, d=8, seed=4)
    tq, tk, tv = _t(q), _t(k[:, :1]), _t(v[:, :1])
    # window 1 over one key: only row 0 sees anything
    out, lse = tatt.flash_fwd_plain(tq, tk, tv, True, 1)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[:, 1:] == 0).all()
    torch.testing.assert_close(lse[..., 1:],
                               torch.full_like(lse[..., 1:], np.log(1e-30)))
    dq = tatt.flash_bwd_dq_plain(tq, tk, tv, out, torch.from_numpy(cot), lse,
                                 True, 1)
    assert torch.isfinite(dq).all() and (dq[:, 1:] == 0).all()


def test_cpu_wrappers_use_the_plain_versions_and_count_no_launch():
    tatt.reset_launches()
    q, k, v, cot, _ = _inputs(b=1, s=16, h=2, hkv=1, d=16, seed=5)
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = tatt.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(cot))
    assert tatt.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0}
    got, lse = tatt.flash_fwd(tq, tk, tv, want_lse=False)
    assert lse is None
    torch.testing.assert_close(got, tatt.reference_attention(tq, tk, tv))


@pytest.mark.parametrize("bad, match", [
    (lambda q, k, v: (q.double(), k.double(), v.double()), "dtype"),
    (lambda q, k, v: (q[..., :8], k[..., :8], v[..., :8]), "head_dim"),
    (lambda q, k, v: (q.transpose(1, 2), k, v), "match"),
    (lambda q, k, v: (q, k[:, :8], v[:, :8]), "s_q == s_k"),
    (lambda q, k, v: (q, k.half(), v), "mixed dtypes"),
    (lambda q, k, v: (q.transpose(0, 1), k.transpose(0, 1),
                      v.transpose(0, 1)), "contiguous"),
])
def test_kernel_input_checks_refuse(bad, match):
    q, k, v = (torch.zeros(2, 16, 4, 16), torch.zeros(2, 16, 2, 16),
               torch.zeros(2, 16, 2, 16))
    with pytest.raises(ValueError, match=match):
        tatt._check_kernel_inputs(*bad(q, k, v))


def test_kernel_input_checks_accept_the_main_path_layout():
    q = torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 2, 128, dtype=torch.bfloat16)
    tatt._check_kernel_inputs(q, k, k.clone(), q.clone(), q.clone())
    tatt._check_rows(torch.zeros(2, 4, 16), q, "lse")
    with pytest.raises(ValueError, match="lse"):
        tatt._check_rows(torch.zeros(2, 16, 4), q, "lse")


def test_wrappers_refuse_mixed_devices():
    cpu = torch.zeros(1, 8, 2, 16)
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tatt.flash_fwd(cpu, meta, cpu)


def test_dispatcher():
    q, k, v, _, _ = _inputs(b=1, s=16, h=2, hkv=1, d=16, seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ref = tatt.reference_attention(tq, tk, tv)
    torch.testing.assert_close(tatt.attention(tq, tk, tv, impl="xla"), ref)
    for impl in ("flash", "auto", "auto_grad"):
        torch.testing.assert_close(tatt.attention(tq, tk, tv, impl=impl),
                                   ref, atol=REF_TOL, rtol=REF_TOL)
    with pytest.raises(ValueError, match="impl"):
        tatt.attention(tq, tk, tv, impl="pallas")
    with pytest.raises(ValueError, match="sliding window"):
        tatt.attention(tq, tk, tv, causal=False, window=4)
