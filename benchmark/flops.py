"""Operation and byte counts, and the peaks they are measured against.

Every count is of what the computation needs at the given shapes, not of
what a kernel happens to execute: attention counts only the (query, key)
pairs the causal mask and the window keep, a routed bank only the experts
each token was sent to, and nothing is counted twice for recomputation.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at its 700 W
limit: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def kept_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs of one causal row set of length `seq`: row r
    sees min(r + 1, window) keys (window 0: no window)."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def matmul_params(spec) -> int:
    """Parameters a token multiplies by in one forward: the projections,
    the MLP (for a routed bank, its top_k experts and the router) and the
    head; the embedding is a lookup."""
    d, hd = spec.d_model, spec.head_dim
    attn = d * spec.n_heads * hd * 2 + d * spec.n_kv_heads * hd * 2
    if spec.moe:
        mlp = spec.top_k * 3 * d * spec.d_ff + d * spec.n_experts
    else:
        mlp = 3 * d * spec.d_ff
    return spec.n_layers * (attn + mlp) + d * spec.vocab


def attention_flops_fwd(spec, batch: int, seq: int) -> int:
    """QK^T and PV over the kept pairs, every layer: 4 * head_dim a pair
    and head."""
    return (spec.n_layers * 4 * spec.head_dim * spec.n_heads * batch
            * kept_pairs(seq, spec.window))


def train_step_flops(spec, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: forward and backward (three times
    the forward) of the matrix products and of attention."""
    tokens = batch * seq
    return 6 * tokens * matmul_params(spec) + 3 * attention_flops_fwd(
        spec, batch, seq)


# ---- the flash kernels ------------------------------------------------------
#
# Per launch at q [B, S, H, D], k/v [B, S, Hkv, D] in bf16, lse [B, H, S]
# f32. The forward needs QK^T and PV (4D a pair and head); dQ alone needs
# S = QK^T, dP = dO V^T and dS K (6D); dK/dV alone needs S, dP, P^T dO and
# dS^T Q (8D). Bytes: each input read once, each output written once.

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def flash_launch(kernel: str, batch: int, seq: int, heads: int,
                 kv_heads: int, head_dim: int, window: int = 0,
                 elem: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of `kernel`."""
    pairs = kept_pairs(seq, window)
    flops = _PAIR_FLOPS[kernel] * head_dim * heads * batch * pairs
    q = batch * seq * heads * head_dim * elem          # q, o, do, dq alike
    kv = batch * seq * kv_heads * head_dim * elem      # k, v, dk, dv alike
    lse = batch * heads * seq * 4
    if kernel == "flash_fwd":
        moved = q + 2 * kv + q + lse                   # q k v -> o lse
    elif kernel == "flash_bwd_dq":
        moved = 3 * q + 2 * kv + lse + q               # q k v o do lse -> dq
    else:
        moved = 3 * q + 2 * kv + lse + 2 * kv          # ... -> dk dv
    return flops, moved


def roofline_seconds(flops: float, moved: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES_PER_S)
