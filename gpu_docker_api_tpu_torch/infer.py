"""Autoregressive inference with a static KV cache, PyTorch port of gpu_docker_api_tpu/infer.py.

Prefill + single-token decode for both model families (llama, moe), with
the JAX package's cache layout and numerics:

- the cache is a static [L, B, S_max, Hkv, D] buffer written in place
  (slice copies), so a decode step never copies it. The JAX version
  donates the cache; here the tensors passed in are overwritten, so a
  cache dict passed in is not reused by the caller either;
- `host_length` mirrors `length` as a plain int: the overflow guard and
  the attend's key range are Python ints, so a decode step makes no
  device sync;
- decode attends over the used prefix only: one pass over exactly the key
  columns [blk_lo * blk, blocks_used * blk) the JAX version's fori_loop
  visits, with its mask and its f32 arithmetic (the result agrees up to
  f32 summation order);
- GQA: the cache holds the n_kv_heads; q is viewed [B, T, Hkv, G, D], so
  no repeated K/V is made;
- kv_quant: int8 K/V with a per-token-per-head f32 scale, dequantized in
  the attend;
- greedy or temperature sampling with top-k / top-p, from an explicit
  torch.Generator; speculative decoding (greedy and rejection sampling).

The generation loops are Python loops over eager steps. Every public entry
point runs under torch.no_grad(): served weights may carry requires_grad,
and a recorded graph through the in-place cache writes would grow with
every token.

MoE layers route the B x T tokens of each step together through
models/moe.moe_block (one capacity over the whole step, as in the JAX
package) and drop its aux losses.

Over ranks (multi-host serving: serving_plan, RankParams) the served
weights are one rank's shards under JAX's serving plan, tp Megatron-style
and fsdp over the rest: each layer's fsdp shards are gathered in the
layer, as in training; wq/wk/wv and w1/w3 are the rank's columns and
wo/w2 its rows, summed over tp (comm.reduce_from_group, in f32); the
embedding is vocab-parallel and the head's vocab shards are gathered whole
for the pick; MoE banks are cut over tp on F, their outputs summed over tp
before the gates weigh them (moe_block). Each rank attends only its own q
heads (both head counts divide by tp; else q, k and v are gathered whole,
training's fallback). A cache that holds every kv head (the default, as
the JAX lock-step batcher replicates it) is written whole, the rank's new
K/V gathered over tp first; a cache cut over tp on the kv-head dim
(serve --shard-kv, batching.kv_shard_specs) holds the rank's own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .device import resolve_device
from .models import family_for
from .models.llama import (LlamaConfig, apply_rope, embed_tokens, gather,
                           head_logits, rms_norm, rope_frequencies, sharded)
from .models.moe import MoEConfig, moe_block
from .ops.quant import _round_int8, qmatmul
from .parallel import comm
from .parallel.mesh import MeshPlan, best_tp_for, head_axis_for


def _llama_view(config) -> LlamaConfig:
    """The attention-side config of either family."""
    return config.as_llama() if isinstance(config, MoEConfig) else config


# ---- serving over ranks -----------------------------------------------------

class RankParams(dict):
    """One rank's served weights under a serving plan: its shards of the
    parameter tree (the Trainer's layout, train.param_specs) and, as
    `groups`, its MeshGroups, over whose fsdp and tp groups every cached
    forward on these weights runs its collectives. Every rank of the plan
    calls each function together, in the same order."""

    def __init__(self, params: dict, groups):
        super().__init__(params)
        self.groups = groups


def serving_plan(n_devices: int, tp: int = 0) -> MeshPlan:
    """JAX's multi-host serving plan over n_devices: tp as asked (0:
    best_tp_for the devices), fsdp the rest (MeshPlan.auto)."""
    return MeshPlan.auto(n_devices, tp=tp or best_tp_for(n_devices))


def _groups(params):
    """(fsdp, tp) AxisGroups of served weights (None, None on one rank)."""
    g = getattr(params, "groups", None)
    return (g.fsdp, g.tp) if g is not None else (None, None)


def _embed(params, tokens):
    """The embedding of tokens [B, T]: on one rank a lookup; over ranks
    the table gathered over fsdp and looked up vocab-parallel over tp."""
    fsdp, tp = _groups(params)
    if fsdp is None and tp is None:
        return F.embedding(tokens, params["embed"])
    return embed_tokens(params, tokens, fsdp, tp)


def _head(params, x, config):
    """Final norm and lm_head -> logits f32 over the whole vocab (over
    ranks the vocab shards gathered whole)."""
    fsdp, tp = _groups(params)
    c = _llama_view(config)
    if fsdp is None and tp is None:
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        return qmatmul(x, params["lm_head"]).float()
    logits = head_logits(params, x, c, fsdp, tp)
    if sharded(tp):
        logits, = comm.all_gather([logits], [logits.dim() - 1], tp)
    return logits


def _split_heads(config, tp) -> bool:
    """Each tp rank computes its own heads (head_axis_for); False on one
    rank or under the head-gather fallback."""
    c = _llama_view(config)
    return (sharded(tp)
            and head_axis_for(tp.size, c.n_heads, c.n_kv_heads) == "tp")


def _kv_for_cache(k, v, cache_heads: int, tp):
    """A layer's new k, v [B,T,hk,D] as a cache of `cache_heads` kv heads
    stores them: as they are, or, where the cache holds every head and the
    rank computed its own, gathered over tp in one collective."""
    if k.shape[2] == cache_heads:
        return k, v
    return comm.all_gather((k, v), (2, 2), tp)


def _rank_heads(buf, hk: int, tp):
    """This rank's hk kv heads of a cache buffer [..., heads, X] (a view;
    the buffer itself when it holds only those)."""
    if buf is None or buf.shape[-2] == hk:
        return buf
    lo = tp.rank * hk
    return buf[..., lo:lo + hk, :]


# ---- the cache --------------------------------------------------------------

def kv_leaves(config, lead: tuple, quantized: bool = False) -> dict:
    """{name: (shape, dtype, fill)} of a cache's K/V buffers of leading
    dims `lead` ([L, batch, S_max] dense, [L, blocks, block] paged), each
    [*lead, Hkv, D]; quantized: int8 K/V and per-token-per-head f32
    scales [*lead, Hkv, 1] (ones until written)."""
    c = _llama_view(config)
    shape = (*lead, c.n_kv_heads, c.head_dim)
    if not quantized:
        return {"k": (shape, c.dtype, 0), "v": (shape, c.dtype, 0)}
    sshape = shape[:-1] + (1,)
    return {"k": (shape, torch.int8, 0), "v": (shape, torch.int8, 0),
            "ks": (sshape, torch.float32, 1),
            "vs": (sshape, torch.float32, 1)}


def alloc_leaves(leaves: dict, device) -> dict:
    """The buffers of kv_leaves on `device`."""
    return {name: torch.full(shape, fill, dtype=dtype, device=device)
            for name, (shape, dtype, fill) in leaves.items()}


@torch.no_grad()
def init_cache(config, batch: int, max_len: int, quantized: bool = False,
               device=None) -> dict:
    """Zeroed KV cache for `batch` sequences of up to `max_len` tokens, on
    `device` (None: the card, raising without one). `host_length` mirrors
    `length` as a plain int.

    quantized=True stores K/V as int8 with a per-token-per-head f32 scale
    ("ks"/"vs", ones until written): half the bytes a decode step reads
    from the cache."""
    dev = resolve_device(device)
    c = _llama_view(config)
    cache = alloc_leaves(kv_leaves(config, (c.n_layers, batch, max_len),
                                   quantized), dev)
    cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
    cache["host_length"] = 0
    return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8: x [B,T,Hkv,D] -> (q int8, scale
    f32 [B,T,Hkv,1])."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return _round_int8(xf, s), s


def _block_for(s_max: int, preferred: int = 128) -> int:
    """Largest power-of-two block size <= preferred dividing s_max."""
    blk = preferred
    while blk > 1 and s_max % blk != 0:
        blk //= 2
    return blk


def blocks_used(pos: int, t: int, blk: int) -> int:
    """How many cache blocks the causal frontier pos+t touches: the attend
    reads that many blocks (FLOPs and bytes grow with the length)."""
    return (pos + t + blk - 1) // blk


class Frontiers:
    """Per-row frontiers of a slot batch (batching.py) for one step, built
    once per step: `host` the positions as Python ints, which the attend's
    key range and the window's dead-block skip read without a device sync,
    and `dev` the same as one device tensor, which the cache writes and
    RoPE read. The write indices are made once per (T, S_max) and shared by
    every layer's writes."""

    def __init__(self, host, dev: torch.Tensor):
        self.host = [int(p) for p in host]
        self.dev = dev.long()
        self._writes = {}

    def write_index(self, t: int, s_max: int):
        """(rows [B,1], cols [B,t]) of a T-token write at each row's
        frontier; a start past S_max - T is clamped, as
        lax.dynamic_update_slice clamps it."""
        key = (t, s_max)
        if key not in self._writes:
            dev = self.dev.device
            start = self.dev.clamp(0, s_max - t)
            self._writes[key] = (
                torch.arange(len(self.host), device=dev)[:, None],
                start[:, None] + torch.arange(t, device=dev))
        return self._writes[key]


def _per_row(pos) -> bool:
    """True for per-row positions (Frontiers or a [B] vector), False for
    one position (an int or a 0-d tensor)."""
    return (isinstance(pos, (list, tuple, Frontiers))
            or getattr(pos, "ndim", 0) == 1)


def _frontiers(pos, device) -> Frontiers:
    """Per-row positions as Frontiers; a [B] vector is read to the host
    (one device sync when it is a device tensor)."""
    if isinstance(pos, Frontiers):
        return pos
    dev = torch.as_tensor(pos, device=device).reshape(-1)
    return Frontiers(dev.tolist(), dev)


def _attend_cached(q, k_all, v_all, pos, k_scale=None, v_scale=None,
                   window: int = 0, active=None):
    """q [B,T,H,D] at absolute positions pos..pos+T-1; k/v_all [B,S_max,
    Hkv,D]. Attention over the cache buffer's used blocks only: the key
    columns [blk_lo * blk, blocks_used(far) * blk), with the causal (and
    window) mask and an f32 softmax. Columns past the frontier's block are
    never read.

    With k_scale/v_scale (int8 cache, [B,S_max,Hkv,1] f32) the read blocks
    are dequantized here.

    pos is an int (the whole batch at one frontier) or per-row frontiers
    (the slot cache of continuous batching): Frontiers, or a [B] sequence.
    The columns then run to the furthest row's frontier with each row
    masked to its own. The per-row bounds are read on the host: from
    Frontiers.host with no device sync, else from pos (one sync when it is
    a device tensor); `active` [B] bool (a host list in the batcher) marks
    the rows whose frontier may move the window's first block.

    GQA: K/V are read at the Hkv head count; q is viewed as [B,T,Hkv,G,D],
    so no repeated K/V is made."""
    t = q.shape[1]
    blk = _block_for(k_all.shape[1])
    per_row = _per_row(pos)
    if per_row:
        fr = _frontiers(pos, q.device)
        pos_t, pos_h = fr.dev, fr.host
        far = max(pos_h)
        # `near` drives the window's dead-block skip; idle slot rows
        # (length 0) must not drag it to 0, so active rows only when a mask
        # is given
        if active is None:
            act = [True] * len(pos_h)
        elif isinstance(active, (list, tuple)):
            act = active
        else:
            act = torch.as_tensor(active).reshape(-1).tolist()
        near = min((p for p, a in zip(pos_h, act) if a), default=2 ** 30)
    else:
        far = near = pos = int(pos)
    # sliding window: blocks wholly before (earliest row - window) are dead
    blk_lo = max((near - window + 1) // blk, 0) if window else 0
    lo, hi = blk_lo * blk, blocks_used(far, t, blk) * blk
    if hi <= lo:          # no row reaches a live block
        return torch.zeros_like(q)

    kb, vb = k_all[:, lo:hi].float(), v_all[:, lo:hi].float()
    if k_scale is not None:
        kb = kb * k_scale[:, lo:hi]
    if v_scale is not None:
        vb = vb * v_scale[:, lo:hi]
    cols = torch.arange(lo, hi, device=q.device)
    steps = torch.arange(t, device=q.device)
    if per_row:
        rows = pos_t[:, None] + steps                          # [B, t]
        mask = cols[None, None, :] <= rows[:, :, None]         # [B, t, n]
        if window:
            mask &= cols[None, None, :] > rows[:, :, None] - window
        mask = mask[:, None, None]                             # [B,1,1,t,n]
    else:
        rows = pos + steps
        mask = cols[None, :] <= rows[:, None]
        if window:
            mask &= cols[None, :] > rows[:, None] - window
    return _softmax_attend(q, kb, vb, mask)


def _softmax_attend(q, kb, vb, mask):
    """softmax(q kᵀ / sqrt(D)) v in f32: q [B,T,H,D]; kb, vb [B,S,Hkv,D]
    f32 (dequantized); mask [B,1,1,T,S] or [T,S], True where a key is
    visible. q is viewed [B,T,Hkv,G,D], so no repeated K/V is made. A row
    that sees no key gives 0, not NaN. Returns [B,T,H,D] in q's dtype."""
    b, t, h, d = q.shape
    hkv = kb.shape[2]
    qf = (q.float() / math.sqrt(d)).reshape(b, t, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
    out = acc / l.clamp_min(1e-30)                             # [b,hkv,g,t,d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write new [B,T,...] into cache [B,S_max,...] in place at start
    position `pos`: an int (one frontier), or Frontiers or a [B] tensor
    (per-row frontiers; a start past S_max - T is clamped, as
    lax.dynamic_update_slice clamps it). Returns `cache`."""
    t = new.shape[1]
    if not _per_row(pos):
        pos = int(pos)
        cache[:, pos:pos + t] = new.to(cache.dtype)
        return cache
    rows, cols = _frontiers(pos, cache.device).write_index(t, cache.shape[1])
    cache.index_put_((rows, cols), new.to(cache.dtype))
    return cache


def _layer_step(x, layer, cache_k, cache_v, pos, config, cos, sin,
                scale_k=None, scale_v=None, active=None, tp=None):
    """One decoder layer over a T-token slice with cache read + write.
    x [B,T,D]; cache_k/v [B,S_max,Hkv,D] (this layer's views, written in
    place); pos = absolute start position (int, or Frontiers / [B] per
    row). With scale_k/scale_v (int8 cache) new K/V quantize on write.
    Under a `tp` group the layer's weights are this rank's slices and it
    attends its own heads. Returns x."""
    q, k, v = _qkv(x, layer, config, cos, sin, tp)
    hk = k.shape[2]
    k, v = _kv_for_cache(k, v, cache_k.shape[-2], tp)
    if scale_k is not None:
        k, ks_new = _quantize_kv(k)
        v, vs_new = _quantize_kv(v)
        _cache_write(scale_k, ks_new, pos)
        _cache_write(scale_v, vs_new, pos)
    _cache_write(cache_k, k, pos)
    _cache_write(cache_v, v, pos)
    kb, vb, sk, sv = (_rank_heads(b, hk, tp)
                      for b in (cache_k, cache_v, scale_k, scale_v))
    out = _attend_cached(q, kb, vb, pos, sk, sv,
                         window=_llama_view(config).sliding_window,
                         active=active)
    return _out_and_mlp(x, out, layer, config, tp)


def _qkv(x, layer, config, cos, sin, tp=None):
    """The attention inputs of one decoder layer over x [B,T,D]: q
    [B,T,H,D] and k [B,T,Hkv,D] with RoPE applied, v [B,T,Hkv,D]; under a
    `tp` group this rank's H/tp and Hkv/tp heads (its columns of wq, wk,
    wv), or under the fallback every head (the columns gathered)."""
    c = _llama_view(config)
    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    # qmatmul == `@` for dense weights; the int8 path for quantized serving
    q, k, v = (qmatmul(h, layer[w]) for w in ("wq", "wk", "wv"))
    cut = tp.size if _split_heads(config, tp) else 1
    if sharded(tp) and cut == 1:
        q, k, v = comm.all_gather((q, k, v), (2, 2, 2), tp)
    q = q.reshape(b, t, c.n_heads // cut, c.head_dim)
    k = k.reshape(b, t, c.n_kv_heads // cut, c.head_dim)
    v = v.reshape(b, t, c.n_kv_heads // cut, c.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _row_parallel(h, w, tp):
    """h @ w, summed over tp (in f32) where w is this rank's rows."""
    out = qmatmul(h, w)
    return comm.reduce_from_group(out, tp) if sharded(tp) else out


def _out_and_mlp(x, out, layer, config, tp=None):
    """The rest of the decoder layer after the attention output out
    [B,T,H,D] (under tp this rank's heads, or every head under the
    fallback, of which it keeps its rows of wo): the output projection and
    the family's FFN (the dense MLP, or the MoE block over the B x T
    tokens, its aux losses dropped), each residual."""
    c = _llama_view(config)
    b, t, _ = x.shape
    out = out.reshape(b, t, -1)
    if sharded(tp) and not _split_heads(config, tp):
        out = out.chunk(tp.size, dim=-1)[tp.rank]
    x = x + _row_parallel(out, layer["wo"], tp)
    if "we1" in layer:
        return moe_block(x, layer, config, tp=tp)[0]
    hm = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    return x + _row_parallel(F.silu(qmatmul(hm, layer["w1"]))
                             * qmatmul(hm, layer["w3"]), layer["w2"], tp)


def _host_length(cache) -> int:
    length = cache.get("host_length")
    return int(cache["length"]) if length is None else length


def _forward_cached(params, tokens, cache, config, last_only=False):
    """tokens [B,T] starting at absolute position host_length. Writes the
    cache in place; returns (logits [B,T,V] f32, or [B,1,V] of the last
    position when last_only, and the cache dict with its lengths moved)."""
    t = tokens.shape[1]
    pos = _host_length(cache)
    x = _embed(params, tokens)
    cos, sin = rope_frequencies(
        _llama_view(config), torch.arange(pos, pos + t, device=tokens.device))
    logits = _run_layers(params, x, cache, pos, config, cos, sin,
                         last_only=last_only)
    out = dict(cache, length=cache["length"].new_full((), pos + t),
               host_length=pos + t)
    return logits, out


def _run_layers(params, x, cache, pos, config, cos, sin, active=None,
                last_only=False, layer_step=None):
    """Every decoder layer over x [B,T,D] with the cache read and written
    in place at `pos` (int, or Frontiers per row), then the final norm and
    lm_head: logits [B,T,V] f32 ([B,1,V] of the last position when
    last_only). `layer_step` (default _layer_step) runs one layer on its
    cache buffers: the paged cache (paging.py) gives its own. Over ranks
    (RankParams) each layer's fsdp shards are gathered before it runs."""
    c = config
    layers = params["layers"]
    family = family_for(config)
    keys = family.layer_keys
    kinds = [family.param_kinds(config)["layers"][name] for name in keys]
    fsdp, tp = _groups(params)
    stacks = [layers[name].unbind(0) for name in keys]
    quantized = "ks" in cache
    layer_step = layer_step or _layer_step
    for i, weights in enumerate(zip(*stacks)):
        weights = gather(weights, kinds, fsdp)
        scales = (cache["ks"][i], cache["vs"][i]) if quantized else ()
        x = layer_step(x, dict(zip(keys, weights)), cache["k"][i],
                        cache["v"][i], pos, c, cos, sin, *scales,
                        active=active, tp=tp)
    if last_only:
        x = x[:, -1:]
    return _head(params, x, c)


def _checked_length(cache, new_tokens: int) -> None:
    """Fail loudly when a write would run past the cache buffer. Uses the
    host-side `host_length` (a hand-built cache without one reads the
    device scalar once)."""
    length = _host_length(cache)
    max_len = cache["k"].shape[2]
    if length + new_tokens > max_len:
        raise ValueError(
            f"KV cache overflow: length {length} + {new_tokens} new "
            f"token(s) exceeds max_len {max_len} — init_cache with a larger "
            f"buffer")


@torch.no_grad()
def prefill(params, tokens, cache, config):
    """Run the prompt through the model, filling the cache. tokens [B,T];
    returns (last-position logits [B,V] f32, cache)."""
    _checked_length(cache, tokens.shape[1])
    logits, cache = _forward_cached(params, tokens, cache, config,
                                    last_only=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params, token, cache, config):
    """One token per sequence: token [B] -> (logits [B,V] f32, cache)."""
    _checked_length(cache, 1)
    logits, cache = _forward_cached(params, token[:, None], cache, config)
    return logits[:, -1], cache


def _filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties with the k-th included); the
    rest go to -inf."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, float("-inf")))


def _filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus sampling: keep the smallest set of tokens whose cumulative
    probability reaches top_p (the top token always survives). The cutoff
    is a logit, so every token tied with the last one inside is kept."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    # cutoff logit: the smallest sorted logit still inside the nucleus
    # (first index where the cumulative probability reaches top_p)
    inside = torch.cumsum(probs, dim=-1) - probs < top_p
    cutoff = torch.where(inside, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, float("-inf")))


def _filtered(logits, temperature: float, top_k: int, top_p: float):
    logits = logits / temperature
    if top_k:
        logits = _filter_top_k(logits, top_k)
    if top_p < 1.0:
        logits = _filter_top_p(logits, top_p)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One sample per row from softmax(logits) (Gumbel-max, on the logits'
    device): [..., V] -> [...] int64. -inf logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _generator_for(generator: Optional[torch.Generator], device
                   ) -> torch.Generator:
    """The caller's generator, or one seeded 0 (the JAX default key(0))."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


@torch.no_grad()
def generate(params, prompt, config, max_new: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: int = 0, top_p: float = 1.0,
             kv_quant: bool = False) -> torch.Tensor:
    """prompt [B, T] -> generated tokens [B, max_new] (int64, on the
    prompt's device). Greedy when temperature == 0, else categorical
    sampling with optional top-k and/or nucleus (top-p) filtering, drawn
    from `generator`. kv_quant=True holds the KV cache in int8."""
    b, t = prompt.shape
    dev = prompt.device
    cache = init_cache(config, b, t + max_new, quantized=kv_quant, device=dev)
    logits, cache = _forward_cached(params, prompt, cache, config,
                                    last_only=True)
    gen = None if temperature == 0.0 else _generator_for(generator, dev)

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        return _categorical(_filtered(logits, temperature, top_k, top_p), gen)

    token = pick(logits[:, -1])
    out = [token]
    # max_new-1 decode forwards produce tokens 2..max_new; the final
    # sampled token needs no further forward pass
    for _ in range(max_new - 1):
        logits, cache = _forward_cached(params, token[:, None], cache, config)
        token = pick(logits[:, -1])
        out.append(token)
    return torch.stack(out, dim=1)


# ---- speculative decoding --------------------------------------------------

@torch.no_grad()
def speculative_generate(params, draft_params, prompt, config, draft_config,
                         max_new: int, gamma: int = 4,
                         kv_quant: bool = False,
                         temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         generator: Optional[torch.Generator] = None):
    """Speculative decoding (Leviathan et al. 2211.17192): a cheap draft
    model proposes `gamma` tokens autoregressively, the target verifies
    all of them in ONE cached forward of gamma+1 positions.

    temperature == 0 — greedy: acceptance keeps the longest proposal
    prefix matching the target's argmax and takes the target's token at
    the first divergence, so the output IS the target-only greedy stream
    for any draft.

    temperature > 0 — rejection sampling: the draft samples its proposals
    from q (after the same temperature/top-k/top-p filtering the target
    uses); token x_j is accepted with probability min(1, p_j(x_j)/q_j(x_j)),
    the first rejection resamples from norm(max(0, p_j - q_j)), and when
    all gamma are accepted the bonus token samples from p. The output's
    marginal distribution is the target-only sampling distribution.

    B=1. One host read per round (how many proposals were accepted), which
    rolls both caches back. Returns (tokens [1, max_new] int64,
    {"rounds", "accepted"} as ints)."""
    b, t = prompt.shape
    if b != 1:
        raise ValueError("speculative_generate is B=1 (per-row cache "
                         "lengths diverge otherwise)")
    sampling = temperature != 0.0
    dev = prompt.device
    gen = _generator_for(generator, dev) if sampling else None

    def filtered_logp(logits):
        """The per-position sampling distribution BOTH models use: logits
        -> log-probs after temperature + top-k + top-p. Rejection sampling
        is exact for whatever (p, q) pair it tests, so the filters are
        baked into both."""
        return torch.log_softmax(_filtered(logits, temperature, top_k, top_p),
                                 dim=-1)

    cap = t + max_new + gamma + 2          # the verify block may overshoot
    t_cache = init_cache(config, 1, cap, quantized=kv_quant, device=dev)
    d_cache = init_cache(draft_config, 1, cap, quantized=kv_quant, device=dev)

    # prefill both; invariant from here on: the caches hold y_1..y_{m-1},
    # `last` = y_m is NOT yet in either cache
    t_logits, t_cache = _forward_cached(params, prompt, t_cache, config,
                                        last_only=True)
    _, d_cache = _forward_cached(draft_params, prompt, d_cache, draft_config,
                                 last_only=True)
    if sampling:
        last = _categorical(filtered_logp(t_logits[:, -1]), gen)      # [1]
    else:
        last = torch.argmax(t_logits[:, -1], dim=-1)
    emitted = [last]
    count = 0                   # emitted holds count + 1 tokens
    rounds = accepted = 0
    while count + 1 < max_new:
        # the draft proposes gamma tokens from `last` (argmax when greedy;
        # sampled from its filtered q when sampling, q kept for the test)
        tok, drafts, dlogp = last, [], []
        for _ in range(gamma):
            lg, d_cache = _forward_cached(draft_params, tok[:, None], d_cache,
                                          draft_config)
            if sampling:
                lp = filtered_logp(lg[:, -1])                          # [1, V]
                tok = _categorical(lp, gen)
                dlogp.append(lp[0])
            else:
                tok = torch.argmax(lg[:, -1], dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts)                                     # [gamma]

        # the target scores last + the gamma proposals in one forward
        block = torch.cat([last, drafts])[None, :]                     # [1, g+1]
        lg, t_cache = _forward_cached(params, block, t_cache, config)

        if not sampling:
            greedy = torch.argmax(lg[0], dim=-1)                       # [g+1]
            ok = drafts == greedy[:-1]
        else:
            tlogp = filtered_logp(lg[0])                               # [g+1, V]
            dlogp = torch.stack(dlogp)                                 # [g, V]
            # accept x_j with probability min(1, p_j(x_j)/q_j(x_j))
            p_tok = tlogp[:-1].gather(-1, drafts[:, None])[:, 0]
            q_tok = dlogp.gather(-1, drafts[:, None])[:, 0]
            u = torch.rand(gamma, generator=gen, device=dev)
            ok = u < torch.exp(torch.clamp(p_tok - q_tok, max=0.0))
        # a = the first rejected proposal (gamma when all are accepted)
        a = int(torch.cat([~ok, ok.new_ones(1)]).int().argmax())
        if not sampling:
            new_tok = greedy[a:a + 1]
        else:
            # replacement at the first rejection: sample from the residual
            # norm(max(0, p_a - q_a)); all accepted: the bonus token from
            # p_gamma (q contributes nothing there)
            p_a = torch.exp(tlogp[a])                                  # [V]
            q_a = torch.exp(dlogp[a]) if a < gamma else torch.zeros_like(p_a)
            resid = torch.clamp(p_a - q_a, min=0.0)
            total = resid.sum()
            # f32 edge: an (impossibly) empty residual falls back to p_a
            resid = torch.where(total > 0, resid / total, p_a)
            new_tok = _categorical(torch.log(resid + 1e-38), gen)[None]
        # emit drafts[0..a-1], then the replacement / divergence token
        emitted += [drafts[:a], new_tok]
        count += 1 + a
        rounds += 1
        accepted += a
        last = new_tok

        # roll both caches back to exactly the accepted entries (y_1..y_m,
        # d_1..d_a). The target wrote gamma+1 and keeps a+1 of them; the
        # draft wrote gamma (through d_{gamma-1}): when a == gamma its d_gamma
        # entry is missing, so one more draft step fills it
        m_minus_1 = t_cache["host_length"] - (gamma + 1)     # before the round
        keep = m_minus_1 + 1 + a
        t_cache = _with_length(t_cache, keep)
        if a == gamma:
            d_cache = _with_length(d_cache, m_minus_1 + gamma)
            _, d_cache = _forward_cached(draft_params, drafts[-1:][None, :],
                                         d_cache, draft_config,
                                         last_only=True)
        else:
            d_cache = _with_length(d_cache, keep)
    tokens = torch.cat(emitted)[None, :max_new]
    return tokens, {"rounds": rounds, "accepted": accepted}


def _with_length(cache: dict, length: int) -> dict:
    """The cache dict moved back (or on) to `length` entries."""
    return dict(cache, length=cache["length"].new_full((), length),
                host_length=length)
