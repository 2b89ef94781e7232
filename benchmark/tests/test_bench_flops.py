"""flops.py against counts made by hand."""

import flops
from reference.spec import Spec


def _spec(**kw):
    base = dict(name="t", family="dense", vocab=100, d_model=8, n_layers=2,
                n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16, max_seq_len=64,
                rope_theta=1e4, norm_eps=1e-5, window=0, dtype=None,
                init_std=0.02)
    base.update(kw)
    return Spec(**base)


def test_kept_pairs_causal_and_windowed():
    # causal S=4: rows see 1, 2, 3, 4 keys
    assert flops.kept_pairs(4) == 10
    # window 2 at S=5: 1, 2, 2, 2, 2
    assert flops.kept_pairs(5, 2) == 9
    # a window at least S long is plain causal
    assert flops.kept_pairs(5, 5) == flops.kept_pairs(5) == 15
    # Mistral's window at S=8192 counts 25.17 M pairs, not the causal 33.6 M
    assert flops.kept_pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    assert flops.kept_pairs(8192) == 8192 * 8193 // 2


def test_matmul_params_dense_and_active_experts():
    s = _spec()
    attn = 8 * 8 * 2 + 8 * 4 * 2          # wq + wo, wk + wv
    assert flops.matmul_params(s) == 2 * (attn + 3 * 8 * 16) + 8 * 100
    m = _spec(family="moe", n_experts=8, top_k=2)
    # two of eight experts, and the router
    assert flops.matmul_params(m) == 2 * (attn + 2 * 3 * 8 * 16 + 8 * 8) \
        + 8 * 100


def test_train_step_flops_counts_attention_once_per_kept_pair():
    s = _spec(window=2)
    fwd_attn = 2 * 4 * 4 * 2 * 3 * flops.kept_pairs(6, 2)   # L, 4D, H, B
    assert flops.attention_flops_fwd(s, 3, 6) == fwd_attn
    assert flops.train_step_flops(s, 3, 6) == \
        6 * 18 * flops.matmul_params(s) + 3 * fwd_attn


def test_flash_launch_counts():
    b, s, h, hkv, d = 2, 8, 4, 2, 16
    pairs = flops.kept_pairs(s)
    q = b * s * h * d * 2
    kv = b * s * hkv * d * 2
    lse = b * h * s * 4
    assert flops.flash_launch("flash_fwd", b, s, h, hkv, d) == (
        4 * d * h * b * pairs, 2 * q + 2 * kv + lse)
    assert flops.flash_launch("flash_bwd_dq", b, s, h, hkv, d) == (
        6 * d * h * b * pairs, 4 * q + 2 * kv + lse)
    assert flops.flash_launch("flash_bwd_dkv", b, s, h, hkv, d) == (
        8 * d * h * b * pairs, 3 * q + 4 * kv + lse)


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(flops.PEAK_BF16_FLOPS, 0) == 1.0
    assert flops.roofline_seconds(0, flops.PEAK_HBM_BYTES_PER_S * 2) == 2.0
