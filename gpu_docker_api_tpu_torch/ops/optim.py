"""Optimizer ops: the gradient norm's sum of squares and the AdamW update as
hand-written CUDA kernels (csrc/optim.cu), beside their plain PyTorch
versions.

They replace no Pallas kernel: the JAX package leaves the optimizer to
optax under XLA. The work is bound by bytes (the update reads g, p, mu and
nu once and writes p, mu and nu once, 14 bytes a bf16 parameter; the norm
reads each gradient once, 2 bytes), and the kernels move each byte once:
one pass with 16-byte vector loads, f32 arithmetic in registers and no
temporaries in device memory.

- sum_squares(tensors): the sum of squares over every tensor, a 0-dim f32
  tensor on their device; the same tensors give the same bits on every run
  (fixed-order partials, no atomics).
- adamw(p, g, mu, nu, norm, ...): one leaf of optax.chain(
  clip_by_global_norm(clip), adamw(...)) in place, computed in f32 from one
  load to one store and rounded once to each tensor's dtype; the clip scale
  is read from the device `norm`, so nothing waits for the host.

On CUDA tensors each launches its kernel and LAUNCHES counts each launch
where it is made (sum_squares one a non-empty tensor, then one
sum_partials a call; adamw one a non-empty leaf); on CPU tensors it runs
its plain version (*_plain), which is also what the card tests hold each
kernel against, within kernel_gap's tolerance. A CUDA tensor the kernel
does not take raises: there is no fallback.
"""

from __future__ import annotations

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
VECTOR_BYTES = 16
# the most blocks (and partials) of one tensor's sum of squares: about one
# wave of 256-thread blocks on the H100's 132 SMs, each striding over the
# tensor
SUM_BLOCKS = 1024

# kernel launches by entry point since the last reset_launches()
LAUNCHES = {"adamw": 0, "sum_squares": 0, "sum_partials": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds <= {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on {sorted(map(str, {t.device for t in tensors}))}"
                     f": the optimizer ops take them all on the CPU or all "
                     f"on one card")


def _check(tensors, dtype=None) -> None:
    for t in tensors:
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"dtype {t.dtype}: the kernels take float32 or "
                             f"bfloat16")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def _launch(name: str, dtype, device, *args) -> None:
    fn = getattr(_build.library(name), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(_DTYPE_CODE[dtype], *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---- sum of squares ---------------------------------------------------------

def sum_squares_plain(tensors) -> torch.Tensor:
    """The sum of squares over every tensor, in f32."""
    parts = [(t.float() * t.float()).sum() for t in tensors]
    return sum(parts[1:], parts[0])


def sum_squares(tensors) -> torch.Tensor:
    """The sum of squares over every tensor, a 0-dim f32 tensor on their
    device (csrc/optim.cu: one read of each tensor, then one pass over the
    partials)."""
    tensors = list(tensors)
    if _on_cpu(tensors):
        return sum_squares_plain(tensors)
    _check(tensors)
    device = tensors[0].device
    blocks = [min(_cdiv(t.numel(), THREADS * VECTOR_BYTES // t.element_size()),
                  SUM_BLOCKS) for t in tensors]
    partials = torch.empty(max(sum(blocks), 1), dtype=torch.float32,
                           device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    at = 0
    for t, n_blocks in zip(tensors, blocks):
        if n_blocks:
            _launch("sum_squares", t.dtype, device, t.data_ptr(), t.numel(),
                    partials.data_ptr() + 4 * at, n_blocks)
            at += n_blocks
    _launch("sum_partials", torch.float32, device, partials.data_ptr(), at,
            out.data_ptr())
    return out


# ---- AdamW ------------------------------------------------------------------

def adamw_plain(p, g, mu, nu, norm, *, clip, lr, b1, b2, bc1, bc2, eps,
                weight_decay) -> None:
    """One leaf's update in place, in f32, each tensor rounded once to its
    dtype: g scaled by clip / norm unless norm < clip (optax's form, on the
    device), m = b1 mu + (1 - b1) g, v = b2 nu + (1 - b2) g^2,
    p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + weight_decay p)."""
    g32 = g.float()
    g32 = torch.where(norm < clip, g32, (g32 / norm) * clip)
    m = mu.float() * b1 + (1 - b1) * g32
    v = nu.float() * b2 + (1 - b2) * (g32 * g32)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    p32 = p.float()
    u = u + weight_decay * p32
    p.copy_(p32 + u * -lr)
    mu.copy_(m)
    nu.copy_(v)


def adamw(p, g, mu, nu, norm, *, clip, lr, b1, b2, bc1, bc2, eps,
          weight_decay) -> None:
    """One leaf's update in place (csrc/optim.cu: one pass). p, g, mu, nu
    of one shape and dtype; norm the global gradient norm, one f32 on their
    device; lr, bc1 (1 - b1**count) and bc2 host floats."""
    if _on_cpu((p, g, mu, nu, norm)):
        adamw_plain(p, g, mu, nu, norm, clip=clip, lr=lr, b1=b1, b2=b2,
                    bc1=bc1, bc2=bc2, eps=eps, weight_decay=weight_decay)
        return
    _check((p, g, mu, nu), p.dtype)
    if not p.shape == g.shape == mu.shape == nu.shape:
        raise ValueError(f"shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(nu.shape)} differ")
    if norm.numel() != 1 or norm.dtype != torch.float32:
        raise ValueError(f"norm must be one float32, got {tuple(norm.shape)} "
                         f"{norm.dtype}")
    if p.numel():
        _launch("adamw", p.dtype, p.device, p.data_ptr(), g.data_ptr(),
                mu.data_ptr(), nu.data_ptr(), p.numel(), norm.data_ptr(),
                clip, lr, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps, weight_decay)


def _ulp(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """One ulp at |x| of a float with that many mantissa bits (f32 math),
    the least normal bf16's at zero."""
    a = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - mantissa_bits)


def kernel_gap(got, want, before) -> int:
    """How many elements of `got` (a tensor the adamw kernel stored) lie
    farther from `want` (the plain version's) than the kernel's tolerance:
    1 ulp of the tensor's dtype at the larger result, or 8 f32 ulps of the
    largest of the two results and the value before the update.

    Both compute in f32, but the plain version's CUDA ops multiply by a
    rounded reciprocal where they divide by a host float (the bias
    corrections), so the two u = (m / bc1) / (sqrt(v / bc2) + eps) differ
    by up to about 4 f32 ulps; lr u can be twice the larger of p and the
    result (p ~ lr u / 2), so p differs by up to 6 f32 ulps of that larger
    value (an emulation in correctly rounded f32, 131 M elements over
    counts 1 to 3); a stored bf16 value can then round the other way.
    mu and nu take the same operations on both sides. Leaving out the
    weight decay or rounding through bf16 in an f32 leaf lies far past it
    (chip_smoke phase 1b and the card tests plant both)."""
    g, w = got.float(), want.float()
    bits = 23 if got.dtype == torch.float32 else 7
    larger = torch.maximum(g.abs(), w.abs())
    tol = torch.maximum(_ulp(larger, bits),
                        8 * _ulp(torch.maximum(larger, before.float().abs()),
                                 23))
    return int(((g - w).abs() > tol).sum())
