"""Attention ops: hand-written Hopper flash kernels + the plain PyTorch math.

The hot op of the training workload (models/llama.py) and of the
sequence-parallel bodies (parallel/ring.py, parallel/ulysses.py).
Counterpart of gpu_docker_api_tpu/ops/attention.py, with its public
layouts: q [B,S,H,D], k/v [B,S,Hkv,D] (GQA: q head h reads kv head
h // (H // Hkv)), lse [B,H,S] f32 of the scaled scores.

- reference_attention: einsum + softmax over repeated kv heads, f32.
- flash_fwd / flash_bwd_dq / flash_bwd_dkv: one wrapper per CUDA kernel
  (csrc/). On a CUDA tensor each launches its kernel and counts the launch
  in LAUNCHES; on a CPU tensor it computes the same function with its plain
  version beside it (flash_*_plain), which is also what chip_smoke.py holds
  each kernel against on the card.
- flash_attention / flash_attention_lse: torch.autograd.Functions over
  those wrappers (forward kernel, then the dq and dk/dv kernels).
- the lse consumers: merge_attention_partials (the exact online-softmax
  merge of partials over disjoint key sets), _pair_lse_banded (one
  offset-windowed chunk pair, einsum) and blockwise_attention (the
  sequence cut into chunk pairs through flash_attention_lse, merged), the
  pieces the ring is built from.
- attention(): the flash|xla|auto|auto_grad dispatcher. "auto" and
  "auto_grad" always take the whole-S flash path: the JAX package's
  crossovers (FLASH_MIN_SEQ*, _auto_block) and its VMEM ceilings
  (FLASH_SINGLE_MAX_*, past which it routes to blockwise_attention) were
  measured on a TPU and are not carried over.

Unlike the TPU kernels, which assert S % block == 0, the CUDA kernels mask a
ragged tail themselves, so every sequence length takes the kernel.
"""

from __future__ import annotations

import math

import torch

from .. import _build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches per kernel wrapper since the last reset_launches()
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_window(causal: bool, window: int) -> None:
    if window and not causal:
        raise ValueError("sliding window requires causal attention")


# ---- reference --------------------------------------------------------------

def _keep_mask(s_q: int, s_k: int, causal: bool, window: int, device):
    """[s_q, s_k] bool of the visible scores, from (s_q, s_k) iotas."""
    rows = torch.arange(s_q, device=device)[:, None]
    cols = torch.arange(s_k, device=device)[None, :]
    keep = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    return keep


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    return x.float().repeat_interleave(group, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,Sk,Hkv,D] -> [B,S,H,D]. f32 softmax.
    window > 0 = sliding-window: row r attends keys (r-window, r] only."""
    _check_window(causal, window)
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf = q.float() / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, _repeat_kv(k, group))
    if causal or window:
        keep = _keep_mask(s, k.shape[1], causal, window, q.device)
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(v, group))
    return out.to(q.dtype)


# ---- plain versions of the three kernels ------------------------------------
#
# The same functions the kernels compute, written with the [S, S] scores
# materialized: residuals q, k, v, o, lse; delta_i = rowsum(dO_i * O_i) - dlse_i;
# P = exp(S - lse); dV = P^T dO; dS = P * (dO V^T - delta); dQ = scale dS K;
# dK = scale dS^T Q (both summed over the GQA group for dK / dV).

def _scaled_scores(q, k, causal, window):
    """-> [B,H,S,S] f32 scaled scores with masked entries at -inf."""
    s, d = q.shape[1], q.shape[3]
    group = q.shape[2] // k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          _repeat_kv(k, group)) / math.sqrt(d)
    keep = _keep_mask(s, k.shape[1], causal, window, q.device)
    return scores.masked_fill(~keep, float("-inf"))


def _probs(scores, lse):
    p = torch.exp(scores - lse[..., None])
    return torch.where(torch.isfinite(scores), p, torch.zeros_like(p))


def flash_fwd_plain(q, k, v, causal=True, window=0, want_lse=True):
    """-> (out [B,S,H,D] in q's dtype, lse [B,H,S] f32 or None)."""
    scores = _scaled_scores(q, k, causal, window)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = _probs(scores, m_safe)
    denom = p.sum(dim=-1).clamp_min(1e-30)
    group = q.shape[2] // k.shape[2]
    out = torch.einsum("bhqk,bkhd->bqhd", p / denom[..., None],
                       _repeat_kv(v, group))
    lse = (m_safe + torch.log(denom)) if want_lse else None
    return out.to(q.dtype), lse


def _bwd_terms(q, k, v, o, do, lse, causal, window, dlse):
    """(P, dS) [B,H,S,S] f32 of the backward."""
    group = q.shape[2] // k.shape[2]
    p = _probs(_scaled_scores(q, k, causal, window), lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _repeat_kv(v, group))
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [B,H,S]
    if dlse is not None:
        delta = delta - dlse
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, o, do, lse, causal=True, window=0, dlse=None):
    """-> dq [B,S,H,D] in q's dtype."""
    _, ds = _bwd_terms(q, k, v, o, do, lse, causal, window, dlse)
    group = q.shape[2] // k.shape[2]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k, group))
    return (dq / math.sqrt(q.shape[3])).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, o, do, lse, causal=True, window=0,
                        dlse=None):
    """-> (dk, dv) [B,S,Hkv,D] in k's / v's dtype (f32 sums over the group)."""
    p, ds = _bwd_terms(q, k, v, o, do, lse, causal, window, dlse)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) / math.sqrt(d)
    dv = dv.reshape(b, s, hkv, h // hkv, d).sum(dim=3)
    dk = dk.reshape(b, s, hkv, h // hkv, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---- kernel wrappers --------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"flash attention takes all-CPU or all-CUDA "
                         f"tensors, got {sorted(devices)}")
    return False


def _check_kernel_inputs(q, k, v, *same_as_q):
    """What the CUDA kernels take; raises on anything else."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,D], k/v [B,S,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (the kernels need s_q == s_k)")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads not a multiple of {k.shape[2]} kv "
                         f"heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype}: the kernels take float32 or "
                         f"bfloat16")
    for t in (k, v, *same_as_q):
        if t.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {q.dtype} and {t.dtype}")
    for t in (q, k, v, *same_as_q):
        if t.device != q.device:
            raise ValueError("tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    if q.numel() == 0:
        raise ValueError(f"empty input {tuple(q.shape)}")


def _check_rows(t, q, name):
    """lse / dlse: [B,H,S] f32 contiguous on q's device."""
    b, s, h, _ = q.shape
    if (t.shape != (b, h, s) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous [B,H,S] float32 "
                         f"tensor on {q.device}, got {tuple(t.shape)} "
                         f"{t.dtype}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, q: torch.Tensor, *args) -> None:
    fn = getattr(_build.library(name), name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(_DTYPE_CODE[q.dtype], *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def flash_fwd(q, k, v, causal=True, window=0, want_lse=True):
    """Forward kernel (csrc/flash_fwd.cu). -> (out [B,S,H,D] in q's dtype,
    lse [B,H,S] f32, or None when want_lse is False)."""
    _check_window(causal, window)
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal, window, want_lse)
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if want_lse else None)
    _launch("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), _ptr(lse), b, s, h, k.shape[2], d, int(causal),
            int(window))
    return out, lse


def flash_bwd_dq(q, k, v, o, do, lse, causal=True, window=0, dlse=None):
    """dQ kernel (csrc/flash_bwd_dq.cu). -> dq [B,S,H,D] in q's dtype."""
    _check_window(causal, window)
    if _on_cpu(q, k, v, o, do, lse, dlse):
        return flash_bwd_dq_plain(q, k, v, o, do, lse, causal, window, dlse)
    _check_kernel_inputs(q, k, v, o, do)
    _check_rows(lse, q, "lse")
    if dlse is not None:
        _check_rows(dlse, q, "dlse")
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(dlse),
            dq.data_ptr(), b, s, h, k.shape[2], d, int(causal), int(window))
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, causal=True, window=0, dlse=None):
    """dK/dV kernel (csrc/flash_bwd_dkv.cu). -> (dk, dv) [B,S,Hkv,D]."""
    _check_window(causal, window)
    if _on_cpu(q, k, v, o, do, lse, dlse):
        return flash_bwd_dkv_plain(q, k, v, o, do, lse, causal, window, dlse)
    _check_kernel_inputs(q, k, v, o, do)
    _check_rows(lse, q, "lse")
    if dlse is not None:
        _check_rows(dlse, q, "dlse")
    b, s, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # bf16: the kernel's pre-pass writes delta = rowsum(dO * O) - dlse here
    delta = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
             if q.dtype == torch.bfloat16 else None)
    _launch("flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(dlse),
            _ptr(delta), dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], d,
            int(causal), int(window))
    return dk, dv


# ---- autograd wiring --------------------------------------------------------

def _backward(ctx, do, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    do = do.contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, out, do, lse, ctx.causal, ctx.window, dlse)
    dk, dv = flash_bwd_dkv(q, k, v, out, do, lse, ctx.causal, ctx.window,
                           dlse)
    return dq, dk, dv, None, None


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        # the lse residual is written only when a backward will read it
        train = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(q, k, v, causal, window, want_lse=train)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class _FlashLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_fwd(q, k, v, causal, window, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable flash attention: the forward kernel, and the dq and
    dk/dv kernels in the backward (no [S, S] tensor in either direction on
    the card). q [B,S,H,D], k/v [B,S,Hkv,D]."""
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal, window)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns lse [B,H,S] f32 of the scaled
    scores, differentiable in both outputs (the lse cotangent enters the
    backward kernels' delta term: d lse_i / d s_ij = p_ij)."""
    return _FlashLse.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal, window)


# ---- the lse consumers ------------------------------------------------------

def merge_attention_partials(outs, lses):
    """Combine attention outputs over DISJOINT key sets: outs [N][B,S,H,D]
    (each softmax-normalized within its set), lses [N][B,H,S]. Returns the
    attention over the union, exactly (online softmax across partials), in
    outs[0]'s dtype; differentiable through both operands. A row whose
    lse is -inf in a partial takes nothing from it (weight 0, no NaN)."""
    m = lses[0]
    for lse in lses[1:]:
        m = torch.maximum(m, lse)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = den = None
    for o, lse in zip(outs, lses):
        w = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe),
                        torch.zeros_like(lse))                  # [B,H,S]
        term = o.float() * w.transpose(1, 2)[..., None]         # [B,S,H,D]
        num = term if num is None else num + term
        den = w if den is None else den + w
    den_q = den.transpose(1, 2)[..., None].clamp_min(1e-30)
    return (num / den_q).to(outs[0].dtype)


def _pair_lse_banded(q, k_cur, v_cur, offset: int, window: int):
    """(out, lse) of q against ONE K/V chunk sitting `offset` positions
    behind it in global order (0 = the diagonal chunk), causal and
    sliding-window masked at global positions; out is softmax-normalized
    within the pair, lse [B,H,S] merges it with other chunks' partials.
    A plain f32 einsum, as in JAX: the kernels have no offset-window mode.
    Rows that see no key get out 0 and lse -inf (zero gradients)."""
    b, s_loc, h, d = q.shape
    group = h // k_cur.shape[2]
    qf = q.float() / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, _repeat_kv(k_cur, group))
    rows = torch.arange(s_loc, device=q.device)[:, None]
    cols = torch.arange(s_loc, device=q.device)[None, :]
    delta = rows - cols + offset             # row_global - col_global
    keep = (delta >= 0) & (delta < window)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1)                                          # [B,H,S]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = _probs(s, m_safe)
    l = p.sum(dim=-1)                                           # [B,H,S]
    out = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(v_cur, group)) / (
        l.clamp_min(1e-30).transpose(1, 2)[..., None])
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float("-inf")))
    return out.to(q.dtype), lse


# blockwise_attention's chunk length, and the most chunk pairs one launch
# stacks along the batch axis. Stacking changes no result; it bounds the
# launches (and, on the TPU, the compiled programs) at any S.
FLASH_CHUNK_SEQ = 2048
FLASH_PAIR_STACK = 32


def _stack_groups(n_pairs: int) -> list[int]:
    """Sizes of the consecutive groups the past pairs launch in: the
    largest power-of-two share of FLASH_PAIR_STACK that fits what is
    left (28 pairs -> 16, 8, 4)."""
    cap = max(FLASH_PAIR_STACK, 1)
    sizes = [g for g in (cap, cap // 2, cap // 4, cap // 8, 4, 2, 1)
             if g >= 1]
    out, left = [], n_pairs
    while left:
        g = next(g for g in sizes if g <= left)
        out.append(g)
        left -= g
    return out


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        chunk: int = 0) -> torch.Tensor:
    """Attention with the sequence cut into chunks: each (q-chunk,
    kv-chunk) pair runs through flash_attention_lse (diagonal pairs causal
    or windowed, past pairs full), and each q-chunk's partials merge with
    merge_attention_partials: ring attention's decomposition within one
    device. Differentiable end to end through the kernels. s <= chunk is
    one flash_attention call.

    Causal without a window: the n diagonal pairs run as ONE causal launch
    stacked along the batch axis, and the n(n-1)/2 past pairs in
    power-of-two groups of at most FLASH_PAIR_STACK (_stack_groups).
    Otherwise a loop over the pairs: with a window, a past chunk wholly
    inside the window is a full kernel pair, the partially masked boundary
    chunk a _pair_lse_banded einsum, and chunks wholly outside are
    skipped.

    The chunks are cut from f32 copies of q, k and v and cast back to
    their dtype for each pair (exact: the values are the dtype's), so a
    chunk's gradient sums its pairs' in f32 and rounds once; the JAX
    function sums bf16 cotangents in bf16."""
    _check_window(causal, window)
    b, s, h, d = q.shape
    chunk = chunk or FLASH_CHUNK_SEQ
    if s <= chunk:
        return flash_attention(q, k, v, causal=causal, window=window)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    n = s // chunk

    dtype = q.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()

    def piece(x, i):
        return x[:, i * chunk:(i + 1) * chunk].to(dtype)

    if causal and not window:
        qs = q32.reshape(b, n, chunk, h, d)
        ks = k32.reshape(b, n, chunk, k.shape[2], d)
        vs = v32.reshape(b, n, chunk, v.shape[2], d)

        def stack(x, idx):     # [b, n, c, H, D] -> [len(idx) * b, c, H, D]
            g = x[:, idx]                                   # [b, P, c, H, D]
            return g.transpose(0, 1).reshape(len(idx) * b, chunk,
                                             x.shape[3], d).to(dtype)

        every = list(range(n))
        diag_o, diag_l = flash_attention_lse(
            stack(qs, every), stack(ks, every), stack(vs, every), causal=True)
        pairs = [(i, j) for i in range(n) for j in range(i)]
        past_o, past_l = {}, {}
        pos = 0
        for g in _stack_groups(len(pairs)):
            grp = pairs[pos:pos + g]
            pos += g
            po, pl = flash_attention_lse(
                stack(qs, [i for i, _ in grp]), stack(ks, [j for _, j in grp]),
                stack(vs, [j for _, j in grp]), causal=False)
            for t, pair in enumerate(grp):
                past_o[pair] = po[t * b:(t + 1) * b]
                past_l[pair] = pl[t * b:(t + 1) * b]
        out_chunks = []
        for i in range(n):
            outs = [past_o[(i, j)] for j in range(i)]
            lses = [past_l[(i, j)] for j in range(i)]
            outs.append(diag_o[i * b:(i + 1) * b])
            lses.append(diag_l[i * b:(i + 1) * b])
            out_chunks.append(merge_attention_partials(outs, lses))
        return torch.cat(out_chunks, dim=1)

    out_chunks = []
    for i in range(n):
        qi = piece(q32, i)
        outs, lses = [], []
        for j in range(i + 1 if causal else n):
            offset = (i - j) * chunk
            if window and offset >= window + chunk - 1:
                continue                      # wholly outside the window
            kj, vj = piece(k32, j), piece(v32, j)
            if causal and j == i:
                o, lse = flash_attention_lse(qi, kj, vj, causal=True,
                                             window=window)
            elif window and offset > window - chunk:
                # the partially masked boundary chunk: offset band, einsum
                o, lse = _pair_lse_banded(qi, kj, vj, offset, window)
            else:
                # a past chunk wholly inside the window (or non-causal):
                # a full pair through the kernels
                o, lse = flash_attention_lse(qi, kj, vj, causal=False)
            outs.append(o)
            lses.append(lse)
        out_chunks.append(merge_attention_partials(outs, lses))
    return torch.cat(out_chunks, dim=1)


# ---- dispatcher -------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = "auto",
              window: int = 0) -> torch.Tensor:
    """Dispatch: "xla" = reference_attention; "flash", "auto" and
    "auto_grad" = flash_attention (the kernels on a CUDA tensor, their
    plain versions on a CPU tensor)."""
    if impl == "xla":
        return reference_attention(q, k, v, causal=causal, window=window)
    if impl not in ("flash", "auto", "auto_grad"):
        raise ValueError(f"impl {impl!r}: flash|xla|auto|auto_grad")
    return flash_attention(q, k, v, causal=causal, window=window)
