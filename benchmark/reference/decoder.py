"""Plain PyTorch reference of the Mistral / Mixtral decoder: forward, loss,
gradients and AdamW, in float32 with TF32 off.

It follows the published architecture: RMSNorm, split-half RoPE, grouped
query attention (causal, or within a sliding window), a SwiGLU MLP or a
top-k routed bank of SwiGLU experts, an untied head. What the source
leaves open follows the configuration file's `assumed` keys: a static
per-expert capacity max(int(cf * k * T / E), k) over the T tokens of a
step, choices ranked k-major (every token's first choice before any
token's second) and dropped past it, the selected gates renormalised, the
Switch load-balance and z losses added to the cross-entropy.

The arithmetic is float32 throughout; the stored state keeps the type the
configuration states for it (spec.leaf_shapes: the matrices in the model
dtype, norms and router in float32, AdamW's moments in their parameter's
type), and each update is rounded to it once, when it is stored.

Everything runs layer by layer: the forward keeps only each layer's input,
the backward recomputes one layer at a time, attention is computed in
blocks of query rows, and the experts one at a time. `precision="fp8"`
rounds both inputs of every matrix product to float8 e4m3 with one scale
per tensor: the control, the next precision below the model's bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .spec import Spec

ROW_BLOCK = 1024          # query rows per attention block
FP8_MAX = 448.0           # largest finite float8 e4m3 value


def pin_f32() -> None:
    """Full float32 matrix products: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor, back in
    float32; the gradient passes the rounding unchanged."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        low = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (low - x).detach()


def _in(x: torch.Tensor, precision: str) -> torch.Tensor:
    return fp8(x) if precision == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _in(a, precision) @ _in(b, precision)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope_tables(spec: Spec, seq: int, device):
    inv = 1.0 / (spec.rope_theta ** (torch.arange(
        0, spec.head_dim, 2, dtype=torch.float32, device=device)
        / spec.head_dim))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, Dh], split-half rotation by position."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v, window: int, precision: str) -> torch.Tensor:
    """q [B, S, H, Dh], k/v [B, S, Hkv, Dh] -> [B, S, H, Dh]: row r attends
    keys c <= r, and c > r - window under a window; blocks of ROW_BLOCK
    query rows, each against the keys it can see."""
    b, s, h, dh = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for r0 in range(0, s, ROW_BLOCK):
        r1 = min(s, r0 + ROW_BLOCK)
        c0 = max(0, r0 - window + 1) if window else 0
        scores = torch.einsum("bqhd,bkhd->bhqk", _in(q[:, r0:r1], precision),
                              _in(k[:, c0:r1], precision)) * scale
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(c0, r1, device=q.device)[None, :]
        keep = cols <= rows
        if window:
            keep = keep & (cols > rows - window)
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", _in(probs, precision),
                                 _in(v[:, c0:r1], precision)))
    return torch.cat(outs, dim=1)


def moe_mlp(h: torch.Tensor, w: dict, spec: Spec, precision: str):
    """h [B, S, D] -> (out [B, S, D], aux, z) of the routed expert bank."""
    b, s, d = h.shape
    t = b * s
    e, k = spec.n_experts, spec.top_k
    ht = h.reshape(t, d)
    logits = mm(ht, w["router"], precision)                   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    choice = idx[:, :k]                                        # [T, K]
    cap = max(int(spec.capacity_factor * k * t / e), k)
    onehot = F.one_hot(choice, e)                              # [T, K, E]
    kmajor = onehot.permute(1, 0, 2).reshape(k * t, e)
    before = torch.cumsum(kmajor, dim=0) - kmajor
    pos = (before * kmajor).sum(dim=-1).reshape(k, t).t()      # [T, K]
    keep = pos < cap
    frac = onehot[:, 0, :].sum(dim=0).float() / t
    aux = e * (frac * probs.mean(dim=0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    out = torch.zeros_like(ht)
    for x in range(e):
        tok, slot = torch.nonzero((choice == x) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = ht.index_select(0, tok)
        y = mm(F.silu(mm(rows, w["we1"][x], precision))
               * mm(rows, w["we3"][x], precision), w["we2"][x], precision)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    return out.reshape(b, s, d), aux, z


def layer_forward(x, w: dict, spec: Spec, cos, sin, precision: str):
    """One decoder layer on f32 weights `w` -> (x', aux, z); aux and z are
    zero for a dense layer."""
    b, s, _ = x.shape
    h = rms_norm(x, w["attn_norm"], spec.norm_eps)
    q = mm(h, w["wq"], precision).reshape(b, s, spec.n_heads, spec.head_dim)
    kk = mm(h, w["wk"], precision).reshape(b, s, spec.n_kv_heads,
                                           spec.head_dim)
    v = mm(h, w["wv"], precision).reshape(b, s, spec.n_kv_heads,
                                          spec.head_dim)
    o = attention(rope(q, cos, sin), rope(kk, cos, sin), v, spec.window,
                  precision)
    x = x + mm(o.reshape(b, s, -1), w["wo"], precision)
    h = rms_norm(x, w["mlp_norm"], spec.norm_eps)
    if spec.moe:
        out, aux, z = moe_mlp(h, w, spec, precision)
        return x + out, aux, z
    zero = x.new_zeros(())
    y = mm(F.silu(mm(h, w["w1"], precision)) * mm(h, w["w3"], precision),
           w["w2"], precision)
    return x + y, zero, zero


def layer_names(spec: Spec) -> list:
    base = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    return base + (["router", "we1", "we3", "we2"] if spec.moe
                   else ["w1", "w3", "w2"])


def layer_weights(params: dict, spec: Spec, i: int, grad: bool = False
                  ) -> dict:
    """Layer i's leaves as float32 copies (leaves of their own when
    `grad`)."""
    out = {}
    for n in layer_names(spec):
        t = params[f"layers.{n}"][i].to(torch.float32, copy=True)
        out[n] = t.requires_grad_(True) if grad else t
    return out


def head_loss(x, params: dict, tokens, spec: Spec, precision: str,
              grad: bool = False):
    """Mean next-token cross-entropy of the trunk's output x [B, S, D];
    with `grad`, (loss, dx, {final_norm, lm_head grads})."""
    fn = params["final_norm"].to(torch.float32, copy=True)
    lm = params["lm_head"].to(torch.float32, copy=True)
    if grad:
        x = x.detach().requires_grad_(True)
        fn.requires_grad_(True)
        lm.requires_grad_(True)
    with torch.enable_grad() if grad else torch.no_grad():
        logits = mm(rms_norm(x, fn, spec.norm_eps), lm, precision)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, spec.vocab),
                               tokens[:, 1:].reshape(-1))
    if not grad:
        return loss
    dx, dfn, dlm = torch.autograd.grad(loss, [x, fn, lm])
    return loss.detach(), dx, {"final_norm": dfn, "lm_head": dlm}


def forward_loss(params: dict, tokens, spec: Spec, precision: str = "f32"):
    """(loss, [input of every layer, then the trunk's output]) with no
    gradient."""
    b, s = tokens.shape
    cos, sin = rope_tables(spec, s, tokens.device)
    with torch.no_grad():
        x = params["embed"][tokens].float()
        xs, extra = [], x.new_zeros(())
        for i in range(spec.n_layers):
            xs.append(x)
            x, aux, z = layer_forward(x, layer_weights(params, spec, i), spec,
                                      cos, sin, precision)
            extra = extra + (spec.router_aux_weight * aux
                             + spec.router_z_weight * z)
        xs.append(x)
        loss = head_loss(x, params, tokens, spec, precision)
    return loss + extra, xs


def backprop(params: dict, tokens, spec: Spec, on_grad, precision="f32"):
    """Loss and gradients, layer by layer: on_grad(path, layer index or
    None, f32 gradient) for every leaf, from the head down to the
    embedding. Returns the loss."""
    b, s = tokens.shape
    cos, sin = rope_tables(spec, s, tokens.device)
    loss, xs = forward_loss(params, tokens, spec, precision)
    _, dx, head = head_loss(xs[-1], params, tokens, spec, precision,
                            grad=True)
    for path, g in head.items():
        on_grad(path, None, g)
    for i in reversed(range(spec.n_layers)):
        x = xs[i].requires_grad_(True)
        w = layer_weights(params, spec, i, grad=True)
        with torch.enable_grad():
            y, aux, z = layer_forward(x, w, spec, cos, sin, precision)
            surrogate = (y * dx).sum()
            if spec.moe:
                surrogate = surrogate + (spec.router_aux_weight * aux
                                         + spec.router_z_weight * z)
        grads = torch.autograd.grad(surrogate, [x, *w.values()])
        dx = grads[0]
        for n, g in zip(w, grads[1:]):
            on_grad(f"layers.{n}", i, g)
        del x, w, y, grads
        xs[i] = None
    demb = torch.zeros(params["embed"].shape, dtype=torch.float32,
                       device=dx.device)
    demb.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    on_grad("embed", None, demb)
    return float(loss)


@dataclass
class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay)) with decay on every leaf, as the configuration's
    trainer states it; the learning rate constant."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0


def train_steps(params: dict, batches: list, spec: Spec, opt: AdamW,
                precision: str = "f32", probe=None, after_first=None
                ) -> dict:
    """AdamW steps over `batches` ([B, S] token tensors), in place on
    `params` (and moments made here). Each step takes two passes: the
    first finds the global gradient norm the clip needs, the second
    recomputes the gradients and updates each leaf as its gradient comes.
    probe(path, layer index or None, clipped gradient) sees the first
    step's gradients as the update takes them; after_first(mu) sees the
    first moments once the first step is done.
    Returns {"loss": [per step], "grad_norm": [per step],
    "first_grads": {path: norm of the first step's clipped gradient}}."""
    mu = {p: torch.zeros_like(t) for p, t in params.items()}
    nu = {p: torch.zeros_like(t) for p, t in params.items()}
    out = {"loss": [], "grad_norm": [], "first_grads": {}}
    for step, tokens in enumerate(batches, start=1):
        sq: dict = {}

        def total(path, i, g):
            sq[path] = sq.get(path, 0.0) + float((g * g).sum())
        loss = backprop(params, tokens, spec, total, precision)
        norm = math.sqrt(sum(sq.values()))
        scale = opt.clip / norm if norm >= opt.clip else 1.0
        bc1 = 1.0 - opt.b1 ** step
        bc2 = 1.0 - opt.b2 ** step

        @torch.no_grad()
        def update(path, i, g):
            p = params[path] if i is None else params[path][i]
            m = mu[path] if i is None else mu[path][i]
            n = nu[path] if i is None else nu[path][i]
            g = g * scale
            if probe is not None and step == 1:
                probe(path, i, g)
            m32 = opt.b1 * m.float() + (1 - opt.b1) * g
            n32 = opt.b2 * n.float() + (1 - opt.b2) * g * g
            u = (m32 / bc1) / (torch.sqrt(n32 / bc2) + opt.eps)
            p32 = p.float()
            p.copy_(p32 - opt.lr * (u + opt.weight_decay * p32))
            m.copy_(m32)
            n.copy_(n32)
        backprop(params, tokens, spec, update, precision)
        out["loss"].append(loss)
        out["grad_norm"].append(norm)
        if step == 1:
            out["first_grads"] = {p: math.sqrt(v) * scale
                                  for p, v in sq.items()}
            if after_first is not None:
                after_first(mu)
    return out


def score_served(params: dict, seqs: list, spec: Spec,
                 precisions=("f32",)) -> dict:
    """Logits at the served positions of each sequence, computed in full
    forwards. seqs: [(tokens [T] long, n_prompt)]; position j >= n_prompt
    - 1 predicts tokens[j + 1]. Returns {precision: [logits [n_served, V]
    per sequence]}, each precision's own forward."""
    out = {p: [] for p in precisions}
    with torch.no_grad():
        for prec in precisions:
            hs = [params["embed"][t[None]].float() for t, _ in seqs]
            tables = [rope_tables(spec, t.shape[0], t.device) for t, _ in seqs]
            for i in range(spec.n_layers):
                w = layer_weights(params, spec, i)
                hs = [layer_forward(h, w, spec, c, s, prec)[0]
                      for h, (c, s) in zip(hs, tables)]
            fn = params["final_norm"].float()
            lm = params["lm_head"].float()
            for h, (t, n0) in zip(hs, seqs):
                last = h[0, n0 - 1:t.shape[0] - 1]
                out[prec].append(mm(rms_norm(last, fn, spec.norm_eps), lm,
                                    prec))
    return out
