"""The bf16 check of chip_smoke.py, on the CPU: the band rms it scales each
element's limit by, and that it passes the plain versions while rejecting
every fault that planted_faults models (the same functions the script runs
on the card at the main path's shape, here at a small one)."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from gpu_docker_api_tpu_torch.ops import attention as att  # noqa: E402

torch.set_num_threads(1)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("s", [64, 100, 256])
def test_band_rms_is_the_rms_of_each_band_of_rows(s):
    rng = np.random.default_rng(s)
    ref = torch.from_numpy(rng.standard_normal((2, s, 3, 8)).astype(np.float32))
    got = cs.band_rms(torch, ref)
    assert got.shape == (2, s, 3, 1)
    for lo in range(0, s, cs.BAND):
        band = ref[:, lo:lo + cs.BAND]
        want = band.square().mean(dim=(1, 3)).sqrt()          # [B, H]
        for r in range(lo, min(lo + cs.BAND, s)):
            torch.testing.assert_close(got[:, r, :, 0], want, rtol=1e-5,
                                       atol=0)


@pytest.fixture(scope="module")
def faults_case():
    rng = np.random.default_rng(0)
    b, s, h, hkv, d = 1, 256, 4, 2, 32
    q, do = _bf16(rng, b, s, h, d), _bf16(rng, b, s, h, d)
    k, v = _bf16(rng, b, s, hkv, d), _bf16(rng, b, s, hkv, d)
    o, lse = att.flash_fwd_plain(q, k, v)
    refs = {"flash_fwd": (o,),
            "flash_bwd_dq": (att.flash_bwd_dq_plain(q, k, v, o, do, lse),),
            "flash_bwd_dkv": att.flash_bwd_dkv_plain(q, k, v, o, do, lse)}
    return (q, k, v, o, do, lse), refs


def test_bf16_check_passes_the_plain_versions(faults_case):
    _, refs = faults_case
    for outputs in refs.values():
        for ref in outputs:
            assert cs.bf16_ok(cs.bf16_readings(torch, ref, ref.float()))


def test_bf16_check_rejects_every_planted_fault(faults_case):
    inputs, refs = faults_case
    least = cs.check_planted_faults(torch, att, inputs, refs)
    assert set(least) == set(refs)
    for ratio, frob in least.values():
        assert ratio > cs.BF16_TOL or frob > cs.BF16_FROB
