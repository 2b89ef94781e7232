"""Int8 weights for the inference path, PyTorch port of gpu_docker_api_tpu/ops/quant.py.

Two modes, chosen per deployment (workloads/serve.py --quantize):

- "w8"  — weight-only int8: weights stay in device memory as int8 plus a
  per-output-channel f32 scale. The product converts the int8 weight to
  the activation dtype and runs as a dense GEMM (f32 accumulation inside
  it); the scale factors out of the contraction and is applied to the
  output in f32.
- "w8a8" — dynamic per-row activation int8 on top of w8: both operands
  int8, an int8 x int8 product into int32 (torch._int_mm), rescaled by
  (row scale x column scale).

Symmetric quantization (no zero point): scale = amax / 127 over the
contraction axis, per output channel, the JAX package's recipe, so both
packages quantize the same weights to the same int8 values. The embedding,
the norms and the MoE expert banks stay dense (the MoE family is not yet
ported).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MODES = ("w8", "w8a8")
# weight keys quantize_params converts: the llama projections and MLP
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


@dataclass(frozen=True)
class QTensor:
    """int8 weight + f32 per-output-channel scale.

    q: int8, the original weight's layout ([in, out] or [L, in, out]);
    s: f32 [out] (or [L, out]), amax / 127 over the contraction axis;
    mode: "w8" | "w8a8"."""
    q: torch.Tensor
    s: torch.Tensor
    mode: str = "w8"

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def unbind(self, dim: int = 0) -> tuple:
        """Per-layer QTensors of a layer-stacked one, as Tensor.unbind."""
        if dim != 0:
            raise ValueError("a QTensor unbinds along its layer axis only")
        return tuple(QTensor(q, s, self.mode)
                     for q, s in zip(self.q.unbind(0), self.s.unbind(0)))


def _round_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], as int8 (round half to
    even, as jnp.round)."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def quantize(w: torch.Tensor, mode: str = "w8") -> QTensor:
    """Symmetric int8 per-out-channel quantization of a weight matrix
    [in, out] or a layer-stacked [L, in, out] (contraction axis = -2)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    wf = w.detach().float()
    s = wf.abs().amax(dim=-2).clamp_min(1e-8) / 127.0          # [..., out]
    return QTensor(q=_round_int8(wf, s[..., None, :]), s=s, mode=mode)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.s[..., None, :]).to(dtype)


# torch._int_mm on a CUDA tensor (cuBLASLt's int8 GEMM) takes only more than
# 16 rows; on the CPU it takes any
_INT_MM_MIN_ROWS = 17


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32. On the card a short
    operand (a decode step has one row per sequence) is padded with zero
    rows up to the GEMM's minimum and the padding's rows are dropped; the
    zero rows change no other row's result."""
    m = a.shape[0]
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        pad = a.new_zeros(_INT_MM_MIN_ROWS - m, a.shape[1])
        return torch._int_mm(torch.cat([a, pad]), b)[:m]
    return torch._int_mm(a, b)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., in] @ w — drop-in for `x @ w` that also accepts a QTensor
    ([in, out] only: the caller unbinds the layer axis first)."""
    if not isinstance(w, QTensor):
        return x @ w
    if w.mode == "w8a8":
        # dynamic per-row activation quantization -> int8 x int8 into int32
        xf = x.float()
        sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = _round_int8(xf, sx)
        y = _int8_matmul(xq.reshape(-1, xq.shape[-1]), w.q)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        return (y.float() * sx * w.s).to(x.dtype)
    # w8: the per-out-channel scale factors out of the contraction, so it
    # applies to the OUTPUT, in f32
    y = x @ w.q.to(x.dtype)
    return (y.float() * w.s).to(x.dtype)


def quantize_params(params: dict, mode: str = "w8") -> dict:
    """Quantize the matmul weights of a llama params tree for inference:
    every QUANT_KEYS leaf under params["layers"] plus lm_head. The
    embedding (a gather) and the norms stay dense."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        if k in layers:
            layers[k] = quantize(layers[k], mode)
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"], mode)
    return out


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("lm_head"), QTensor)
