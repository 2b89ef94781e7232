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
packages quantize the same weights to the same int8 values. The divisions
are true IEEE divisions by tensors on the weight's own device, so the CPU
and the card give the same bits too (--host-load quantizes on the host).
The MoE expert banks are always weight-only int8, consumed by qeinsum. The
embedding, the norms and the MoE router stay dense.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MODES = ("w8", "w8a8")
# weight keys quantize_params converts when present: the projections and
# the llama MLP, in the deployment's mode; the MoE expert banks, in w8 only
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
MOE_EXPERT_KEYS = ("we1", "we2", "we3")


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


def _amax_scale(xf: torch.Tensor, dim: int) -> torch.Tensor:
    """max |xf| over `dim` (at least 1e-8) / 127, kept as that dim. The
    divisor is a tensor on xf's device: a Python number would let a CUDA
    kernel multiply by its reciprocal instead, one rounding away from the
    CPU's (and the JAX package's) quotient."""
    amax = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8)
    return amax / amax.new_tensor(127.0)


def quantize(w: torch.Tensor, mode: str = "w8") -> QTensor:
    """Symmetric int8 per-out-channel quantization of a weight matrix
    [in, out], a layer-stacked [L, in, out] or an expert bank [(L,) E, in,
    out] (contraction axis = -2)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    wf = w.detach().float()
    s = _amax_scale(wf, -2)                                  # [..., 1, out]
    return QTensor(q=_round_int8(wf, s), s=s.squeeze(-2), mode=mode)


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
        sx = _amax_scale(xf, -1)
        xq = _round_int8(xf, sx)
        y = _int8_matmul(xq.reshape(-1, xq.shape[-1]), w.q)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        return (y.float() * sx * w.s).to(x.dtype)
    # w8: the per-out-channel scale factors out of the contraction, so it
    # applies to the OUTPUT, in f32
    y = x @ w.q.to(x.dtype)
    return (y.float() * w.s).to(x.dtype)


def qeinsum(spec: str, a: torch.Tensor, w) -> torch.Tensor:
    """torch.einsum accepting an int8 expert bank (a QTensor [E, in, out]):
    the per-expert-per-out-channel scale factors out of the contraction,
    so it applies to the einsum OUTPUT, in f32. Weight-only (w8) banks
    only: an activation-int8 bank would be silently mis-computed here, so
    it is refused."""
    if not isinstance(w, QTensor):
        return torch.einsum(spec, a, w)
    if w.mode != "w8":
        raise ValueError(
            f"qeinsum consumes weight-only banks; got mode {w.mode!r}")
    # the output-side scale below is w.s[:, None, :]: right ONLY for a
    # 3-dim bank whose expert axis leads the output and whose out axis
    # ends it ([E, in, out] bank -> [E, C, out] output). Any other layout
    # (a layer-stacked bank not unbound, a reordered output) would
    # mis-scale silently: refuse it
    ins, outs = spec.replace(" ", "").split("->")
    bank_spec = ins.split(",")[1]
    if w.q.ndim != 3 or len(bank_spec) != 3 or len(outs) != 3 or \
            outs[0] != bank_spec[0] or outs[-1] != bank_spec[-1]:
        raise ValueError(
            f"qeinsum scale layout: spec {spec!r} with bank shape "
            f"{tuple(w.q.shape)} must contract an [E, in, out] bank into an "
            f"[E, ..., out] output")
    y = torch.einsum(spec, a, w.q.to(a.dtype)) * w.s[:, None, :]
    return y.to(a.dtype)


def quantize_params(params: dict, mode: str = "w8") -> dict:
    """Quantize the matmul weights of a family params tree for inference:
    every QUANT_KEYS leaf under params["layers"] plus lm_head in `mode`,
    and the MoE expert banks when present, always weight-only (qeinsum
    consumes them). The embedding (a gather), the norms and the MoE router
    stay dense."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        if k in layers:
            layers[k] = quantize(layers[k], mode)
    for k in MOE_EXPERT_KEYS:
        if k in layers:
            layers[k] = quantize(layers[k], "w8")
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"], mode)
    return out


def quantize_params_streaming(params_host: dict, mode: str = "w8",
                              device="cuda") -> dict:
    """quantize_params for models whose dense weights do not fit the card:
    `params_host` lives on the HOST (CPU tensors); each leaf is quantized
    there and moved to `device` on its own, so the device only ever holds
    the int8 tree plus the leaf in flight. The same bits as
    quantize_params on the device (quantize's divisions are IEEE on
    both)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")

    def put(x):
        return x.detach().to(device)

    def put_q(w, m):
        qt = quantize(w.detach().cpu(), m)          # host math
        return QTensor(q=put(qt.q), s=put(qt.s), mode=m)

    layers = {}
    for k, w in params_host["layers"].items():
        if k in QUANT_KEYS:
            layers[k] = put_q(w, mode)
        elif k in MOE_EXPERT_KEYS:
            layers[k] = put_q(w, "w8")
        else:
            layers[k] = put(w)
    out = {}
    for k, v in params_host.items():    # in the tree's own order
        out[k] = (layers if k == "layers" else
                  put_q(v, mode) if k == "lm_head" else put(v))
    return out


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("lm_head"), QTensor)
