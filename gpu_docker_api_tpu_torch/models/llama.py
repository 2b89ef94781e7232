"""Llama-3-family transformer, PyTorch port of gpu_docker_api_tpu/models/llama.py.

Parameters keep the JAX package's layout, so weights convert one to one
(convert.py): a plain dict of tensors, matrices stored [in, out], and the
decoder layers stacked on a leading [L] axis. Numerics follow the
reference: matmuls in the config dtype, RMSNorm statistics and the logits
in f32, split-half RoPE in f32. Attention goes through ops/attention.py
(the flash kernels on the card). Under an `sp` group (parallel/comm.SPGroup)
each rank runs its S/sp shard of the tokens, with RoPE at global positions
and attention as ring or Ulysses attention (LlamaConfig.sp_attn). Under an
`fsdp` group each rank holds a shard of every matrix (param_kinds,
parallel/mesh.param_sharding_rules) and gathers it whole at its use, a
decoder layer's inside the layer's body: under remat the recompute gathers
again, so no layer's whole weights outlive their use (ZeRO-3). Under a
`tp` group each rank holds its Megatron slice of every matrix: the normed
input enters wq/wk/wv and w1/w3 through comm.copy_to_group and each
rank's product is its own columns (its heads when both head counts divide
by tp, head_axis_for; else q, k and v are gathered whole, the fallback),
and the outputs of wo and w2 meet in comm.reduce_from_group; the
embedding looks up this rank's vocab chunk and the logits are this rank's
vocab shard [B, S, V/tp] (mesh.logits_spec).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..parallel import comm
from ..parallel.mesh import head_axis_for, param_sharding_rules, spec_dim
from .remat import remat_wrap


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # long-context strategy when the sequence is sharded over sp:
    # "ring" (parallel/ring.py) or "ulysses" (parallel/ulysses.py)
    sp_attn: str = "ring"
    # > 0 = sliding-window attention: each position attends its last
    # `sliding_window` keys only
    sliding_window: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # ---- canned configs (the JAX package's) ----

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        """Llama-3-8B."""
        return cls()

    @classmethod
    def llama_mini(cls) -> "LlamaConfig":
        """~45M params, head_dim 128."""
        return cls(vocab_size=32000, d_model=512, n_layers=4, n_heads=4,
                   n_kv_heads=2, d_ff=1408, max_seq_len=2048)

    @classmethod
    def llama_250m(cls) -> "LlamaConfig":
        """~250M params."""
        return cls(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
                   n_kv_heads=4, d_ff=2816, max_seq_len=4096)

    @classmethod
    def llama_1b(cls) -> "LlamaConfig":
        """~1.07B params: 20 layers, d_model 2048, 16 heads over 8 kv
        heads, head_dim 128 — the port's single-card training config."""
        return cls(vocab_size=32000, d_model=2048, n_layers=20, n_heads=16,
                   n_kv_heads=8, d_ff=5632, max_seq_len=4096)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B-v0.1: the Llama trunk with a 4096-token window."""
        return cls(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=32768,
                   rope_theta=10000.0, sliding_window=4096)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Unit-test config."""
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=128,
                   dtype=torch.float32)


# ---- parameters -------------------------------------------------------------

def param_shapes(config: LlamaConfig) -> dict:
    """{name: (shape, dtype)} tree of init_params, without allocating."""
    c = config
    lq, lkv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    n, f32 = c.n_layers, torch.float32
    return {
        "embed": ((c.vocab_size, c.d_model), c.dtype),
        "layers": {
            "attn_norm": ((n, c.d_model), f32),
            "wq": ((n, c.d_model, lq), c.dtype),
            "wk": ((n, c.d_model, lkv), c.dtype),
            "wv": ((n, c.d_model, lkv), c.dtype),
            "wo": ((n, lq, c.d_model), c.dtype),
            "mlp_norm": ((n, c.d_model), f32),
            "w1": ((n, c.d_model, c.d_ff), c.dtype),   # gate
            "w3": ((n, c.d_model, c.d_ff), c.dtype),   # up
            "w2": ((n, c.d_ff, c.d_model), c.dtype),   # down
        },
        "final_norm": ((c.d_model,), f32),
        "lm_head": ((c.d_model, c.vocab_size), c.dtype),
    }


ATTN_PARAM_KINDS = {
    "attn_norm": "norm", "mlp_norm": "norm",
    "wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
    "wo": "attn_out",
}


def param_kinds(config: LlamaConfig) -> dict:
    """Sharding-kind tree matching init_params' structure (keys into
    parallel.mesh.param_sharding_rules)."""
    return {
        "embed": "embed",
        "layers": {
            **ATTN_PARAM_KINDS,
            "w1": "mlp_in", "w3": "mlp_in", "w2": "mlp_out",
        },
        "final_norm": "norm",
        "lm_head": "lm_head",
    }


def fsdp_dim(kind: str):
    """The dim of one (unstacked) leaf of `kind` that fsdp shards, or
    None."""
    return spec_dim(param_sharding_rules()[kind], "fsdp")


def gather(tensors, kinds, fsdp) -> list:
    """The leaves whole: those of a kind fsdp shards gathered over the
    `fsdp` group in one collective (comm.all_gather), the others as they
    are; all as they are without a group."""
    tensors = list(tensors)
    if not sharded(fsdp):
        return tensors
    idx = [i for i, k in enumerate(kinds) if fsdp_dim(k) is not None]
    full = comm.all_gather([tensors[i] for i in idx],
                           [fsdp_dim(kinds[i]) for i in idx], fsdp)
    for i, t in zip(idx, full):
        tensors[i] = t
    return tensors


def init_from_shapes(shapes: dict, generator: torch.Generator,
                     place=None) -> dict:
    """A parameter tree of `shapes` ({name: (shape, dtype)}, nested) drawn
    on the generator's device, leaf by leaf in the tree's order: norms at
    1, every other leaf N(0, 0.02) from `generator`. `place` (e.g.
    Tensor.cpu) takes each leaf as soon as it is made, so the device holds
    one leaf at a time when it moves them elsewhere; the draws, and so the
    numbers, are the same either way."""
    device = generator.device
    place = place or (lambda t: t)

    def make(name, shape, dtype):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def build(tree):
        return {name: build(v) if isinstance(v, dict)
                else place(make(name, *v)) for name, v in tree.items()}

    return build(shapes)


def init_params(config: LlamaConfig, generator: torch.Generator,
                place=None) -> dict:
    """Random parameters on the generator's device (init_from_shapes).
    Same layout as the JAX init_params (not the same numbers: convert.py
    carries JAX weights)."""
    return init_from_shapes(param_shapes(config), generator, place)


# ---- building blocks --------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics regardless of activation dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_frequencies(config: LlamaConfig, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] in f32 for positions [S] or [B, S]."""
    d = config.head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32,
                            device=positions.device) / d
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, H, Dh]; split-half rotation. cos/sin are [S, Dh/2] (shared
    positions) or [B, S, Dh/2] (per-row positions)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :] if cos.dim() == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.dim() == 2 else sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def sharded(group) -> bool:
    """True when `group` (a parallel.comm.AxisGroup or None) spans
    ranks."""
    return group is not None and group.size > 1


def shard_positions(s_loc: int, sp, device) -> torch.Tensor:
    """Global positions of this rank's s_loc tokens: rank * s_loc + iota."""
    lo = sp.rank * s_loc if sharded(sp) else 0
    return torch.arange(lo, lo + s_loc, device=device)


def _attention_block(x, layer, config: LlamaConfig, cos, sin, impl: str,
                     sp=None, tp=None):
    """Norm + QKV + RoPE + attention + output projection + residual. x is
    this rank's shard of the sequence under an `sp` group; under a `tp`
    group the weights are this rank's column (wq/wk/wv) and row (wo)
    slices."""
    c = config
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    if sharded(tp):
        h = comm.copy_to_group(h, tp)
    q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
    n_tp = tp.size if sharded(tp) else 1
    split = head_axis_for(n_tp, c.n_heads, c.n_kv_heads) == "tp"
    if sharded(tp) and not split:
        # a column shard may cut a head, and split-half RoPE pairs column
        # j with j + head_dim/2: every rank takes all heads
        q, k, v = comm.all_gather((q, k, v), (2, 2, 2), tp)
    heads = n_tp if split else 1
    q = q.reshape(b, s, c.n_heads // heads, c.head_dim)
    k = k.reshape(b, s, c.n_kv_heads // heads, c.head_dim)
    v = v.reshape(b, s, c.n_kv_heads // heads, c.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if sharded(sp) and c.sp_attn == "ulysses":
        # all-to-all head scatter: the whole-sequence kernel on H/sp heads
        from ..parallel.ulysses import ulysses_attention
        out = ulysses_attention(q, k, v, sp, causal=True, impl=impl,
                                window=c.sliding_window, tp=heads)
    elif sharded(sp):
        # K/V shards rotate round the ring; with a window it stops early
        from ..parallel.ring import ring_attention
        out = ring_attention(q, k, v, sp, causal=True, impl=impl,
                             window=c.sliding_window)
    else:
        out = attention(q, k, v, causal=True, impl=impl,
                        window=c.sliding_window)             # [B, S, H, Dh]
    out = out.reshape(b, s, -1)
    if sharded(tp) and not split:
        out = out.chunk(n_tp, dim=-1)[tp.rank]      # the rows of wo held
    out = out @ layer["wo"]
    if sharded(tp):
        out = comm.reduce_from_group(out, tp)
    return x + out


def _mlp_block(x, layer, config: LlamaConfig, tp=None):
    """SwiGLU + residual; under a `tp` group w1/w3 are this rank's
    columns and w2 its rows."""
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if sharded(tp):
        h = comm.copy_to_group(h, tp)
    out = (F.silu(h @ layer["w1"]) * (h @ layer["w3"])) @ layer["w2"]
    if sharded(tp):
        out = comm.reduce_from_group(out, tp)
    return x + out


def vocab_embedding(tokens: torch.Tensor, embed: torch.Tensor, tp
                    ) -> torch.Tensor:
    """The rows of `tokens` from a vocab-parallel table: `embed` is this tp
    rank's chunk [V/tp, D]; ids outside it look up zeros, and the sum over
    the group (one nonzero term a row, so exact) is the lookup."""
    n = embed.shape[0]
    local = tokens - tp.rank * n
    outside = (local < 0) | (local >= n)
    x = F.embedding(local.clamp(0, n - 1), embed)
    return comm.reduce_from_group(x.masked_fill(outside[..., None], 0), tp)


# ---- forward ----------------------------------------------------------------

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w1", "w3",
               "w2")


def embed_tokens(params: dict, tokens: torch.Tensor, fsdp=None, tp=None
                 ) -> torch.Tensor:
    """The embedding of tokens [B, S]: embed gathered over `fsdp`, and
    under `tp` the vocab-parallel lookup."""
    embed, = gather([params["embed"]], ["embed"], fsdp)
    return (vocab_embedding(tokens, embed, tp) if sharded(tp)
            else F.embedding(tokens, embed))


def head_logits(params: dict, x: torch.Tensor, config, fsdp=None, tp=None
                ) -> torch.Tensor:
    """Final norm and lm_head (gathered over `fsdp`) of the trunk's output
    -> logits in f32 (the loss softmax needs the headroom); under `tp`
    this rank's vocab shard."""
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    lm_head, = gather([params["lm_head"]], ["lm_head"], fsdp)
    if sharded(tp):
        x = comm.copy_to_group(x, tp)
    return (x @ lm_head).float()


def layer_body(config: LlamaConfig, cos, sin, impl: str, sp=None, fsdp=None,
               tp=None):
    """One decoder layer: body(x, *weights) -> x, weights this rank's
    shards of one layer's leaves in _LAYER_KEYS order, gathered over
    `fsdp` inside the body (under remat the recompute gathers again).
    llama_forward runs it layer by layer, a pipeline stage over its own
    layers (parallel/pipeline.py)."""
    kinds = param_kinds(config)
    layer_kinds = [kinds["layers"][name] for name in _LAYER_KEYS]

    def body(x, *weights):
        weights = gather(weights, layer_kinds, fsdp)
        layer = dict(zip(_LAYER_KEYS, weights))
        x = _attention_block(x, layer, config, cos, sin, impl, sp, tp)
        return _mlp_block(x, layer, config, tp)
    return body


def llama_forward(params: dict, tokens: torch.Tensor, config: LlamaConfig,
                  impl: str = "auto", sp=None, remat: str = "none",
                  fsdp=None, tp=None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] f32. remat: "none" | "full" |
    "dots" — per-layer checkpointing of the decoder body (models/remat.py).
    Under an `sp` group (parallel.comm.SPGroup) tokens are this rank's
    [B, S/sp] shard and so are the logits; under an `fsdp` or `tp` group
    params are this rank's shards (param_kinds), and under `tp` the logits
    are this rank's vocab shard [..., V/tp]. Every rank calls together."""
    c = config
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, fsdp, tp)
    cos, sin = rope_frequencies(c, shard_positions(s, sp, tokens.device))
    step = remat_wrap(layer_body(c, cos, sin, impl, sp, fsdp, tp), remat)
    # unbind once: the backward stacks the per-layer grads in one go
    stacks = [params["layers"][name].unbind(0) for name in _LAYER_KEYS]
    for weights in zip(*stacks):
        x = step(x, *weights)
    return head_logits(params, x, c, fsdp, tp)
