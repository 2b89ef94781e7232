"""Mixtral-family sparse Mixture-of-Experts transformer, PyTorch port of
gpu_docker_api_tpu/models/moe.py.

The llama decoder skeleton (GQA + RoPE + RMSNorm, the same attention block
and so the same flash kernels on the card) with the dense SwiGLU MLP
replaced by a top-k-routed bank of SwiGLU experts. The parameters keep the
JAX package's layout, so weights convert one to one (convert.py).

Routing follows the reference exactly:

- top-k over the router's f32 softmax, ties broken toward the lower expert
  index (jax.lax.top_k's order; taken here from a stable descending sort,
  since torch.topk promises no order among equal values), the selected
  gates renormalised;
- a STATIC per-expert capacity C = max(int(cf * k * T / E), k) over the T
  tokens of the call, ranked K-major (every token's first choice before
  any token's second); choices past capacity are dropped (weight zero, the
  residual carries the token);
- the experts run in the config dtype on the dispatched [E, C, D] slots;
  the combine sums in f32;
- aux losses: the Switch load-balance term (top-1 share times mean router
  probability) and the router z-loss, both f32.

Single device only: moe_block takes the gather dispatch, as the JAX
package does for one expert shard. The one-hot einsum dispatch of the
multi-shard path is here too, with the same semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.quant import qeinsum
from .llama import (
    LlamaConfig, _attention_block, init_from_shapes, rms_norm,
    rope_frequencies, sharded,
)
from . import llama as _llama
from .remat import remat_wrap


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336          # per-expert hidden
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def as_llama(self) -> LlamaConfig:
        """The attention-side view of this config (shared blocks)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            norm_eps=self.norm_eps, dtype=self.dtype)

    def capacity(self, tokens_per_shard: int) -> int:
        """Static per-expert slot count for a given token count."""
        cap = int(self.capacity_factor * self.top_k * tokens_per_shard
                  / self.n_experts)
        return max(cap, self.top_k)

    # ---- canned configs (the JAX package's) ----

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        return cls()

    @classmethod
    def moe_1b(cls) -> "MoEConfig":
        """~1.12B params: 16 layers, d_model 1024, 8 q / 4 kv heads of
        128, top-2 of 8 experts of d_ff 2560 (~376M active a token)."""
        return cls(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
                   n_kv_heads=4, d_ff=2560, n_experts=8, top_k=2,
                   max_seq_len=2048)

    @classmethod
    def moe_mini(cls) -> "MoEConfig":
        """~100M params, head_dim 128."""
        return cls(vocab_size=32000, d_model=512, n_layers=4, n_heads=4,
                   n_kv_heads=2, d_ff=1024, n_experts=8, top_k=2,
                   max_seq_len=2048)

    @classmethod
    def tiny(cls) -> "MoEConfig":
        """Unit-test config."""
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=96, n_experts=4, top_k=2,
                   max_seq_len=128, dtype=torch.float32)


# ---- parameters -------------------------------------------------------------

_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_LAYER_KEYS = _ATTN_KEYS + ("router", "we1", "we3", "we2")


def param_shapes(config: MoEConfig) -> dict:
    """{name: (shape, dtype)} tree of init_params, without allocating: the
    llama attention leaves, the f32 router [L, D, E] and the expert banks
    we1/we3 [L, E, D, F] and we2 [L, E, F, D] in the config dtype."""
    c = config
    dense = _llama.param_shapes(c.as_llama())
    n, e = c.n_layers, c.n_experts
    layers = {k: dense["layers"][k] for k in _ATTN_KEYS}
    # router in f32: its softmax decides routing, keep it exact
    layers["router"] = ((n, c.d_model, e), torch.float32)
    layers["we1"] = ((n, e, c.d_model, c.d_ff), c.dtype)
    layers["we3"] = ((n, e, c.d_model, c.d_ff), c.dtype)
    layers["we2"] = ((n, e, c.d_ff, c.d_model), c.dtype)
    return {**dense, "layers": layers}


def param_kinds(config: MoEConfig) -> dict:
    """Sharding-kind tree (keys into parallel.mesh.param_sharding_rules).
    Shape bookkeeping only: MoE training under dp/fsdp is not yet
    ported."""
    return {
        "embed": "embed",
        "layers": {
            **_llama.ATTN_PARAM_KINDS,
            "router": "router",
            "we1": "expert_in", "we3": "expert_in", "we2": "expert_out",
        },
        "final_norm": "norm",
        "lm_head": "lm_head",
    }


def init_params(config: MoEConfig, generator: torch.Generator,
                place=None) -> dict:
    """Random parameters on the generator's device (llama.init_from_shapes:
    norms at 1, every other leaf N(0, 0.02)). Same layout as the JAX
    init_params (not the same numbers: convert.py carries JAX weights)."""
    return init_from_shapes(param_shapes(config), generator, place)


# ---- the MoE block ----------------------------------------------------------

def capacity_positions(onehot: torch.Tensor) -> torch.Tensor:
    """onehot [T, K, E] -> each (token, k) choice's position within its
    expert's capacity, [T, K] (int64). Ranked K-MAJOR (all k=0 rows first)
    so every token's top-1 pick wins a slot before any token's k=1
    spillover competes for one: the GShard priority policy.

    The running count is taken along each expert's row of an [E, K*T]
    copy: a scan along a tensor's last dimension runs in parallel on the
    card, where a scan down the K*T rows of a [K*T, E] tensor runs one
    thread an expert, serially."""
    t, k, e = onehot.shape
    flat = onehot.to(torch.int32).permute(2, 1, 0).reshape(e, k * t)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - 1  # [E, K*T]
    pos = pos.reshape(e, k, t).permute(2, 1, 0)              # [T, K, E]
    return (pos * onehot).sum(dim=-1)                        # [T, K]


def weighted_router_loss(aux, z, config: MoEConfig):
    """The router objective added to CE: load-balance and z losses under
    their config weights (moe_forward applies it to the layer sums)."""
    return config.router_aux_weight * aux + config.router_z_weight * z


def _route(ht: torch.Tensor, router: torch.Tensor, config: MoEConfig):
    """Routing of ht [T, D] (f32 router [D, E]): (logits [T, E] f32, probs
    [T, E], gate_vals [T, K] renormalised, gate_idx [T, K] int64, onehot
    [T, K, E], pos_in_expert [T, K], keep [T, K] bool, cap).

    The top k come from a stable descending sort: among equal
    probabilities the lower expert index comes first, as jax.lax.top_k
    orders them, so capacity ranks and drops are the reference's."""
    c = config
    logits = ht.float() @ router                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :c.top_k], idx[:, :c.top_k]
    # Mixtral renormalizes the selected gates
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    cap = c.capacity(ht.shape[0])
    onehot = F.one_hot(gate_idx, c.n_experts)                 # [T, K, E]
    pos_in_expert = capacity_positions(onehot)
    keep = pos_in_expert < cap
    return (logits, probs, gate_vals, gate_idx, onehot, pos_in_expert, keep,
            cap)


def _expert_matmuls(xe: torch.Tensor, layer: dict) -> torch.Tensor:
    """The per-expert SwiGLU bank over dispatched slots xe [E, C, D] ->
    [E, C, D] (qeinsum == einsum for dense banks; int8 w8 banks for
    serving). Shared by both dispatch paths; batched products (bmm), which
    remat "dots" recomputes rather than saves, as JAX's
    dots_with_no_batch_dims_saveable does."""
    g = qeinsum("ecd,edf->ecf", xe, layer["we1"])
    u = qeinsum("ecd,edf->ecf", xe, layer["we3"])
    y = F.silu(g) * u                                         # SwiGLU
    return qeinsum("ecf,efd->ecd", y, layer["we2"])           # [E, C, D]


def _moe_experts_einsum(ht, layer, c: MoEConfig, gate_idx, gate_vals, keep,
                        pos_in_expert, cap: int) -> torch.Tensor:
    """Dense-dispatch expert path: one-hot dispatch/combine EINSUMS
    (td,tec->ecd and back). The multi-shard path of the JAX package, where
    an expert-sharded mesh turns the pair into all-to-alls; O(T·E·C·D)
    products. Same semantics as _moe_experts_gather. Returns [T, D] f32."""
    onehot = F.one_hot(gate_idx, c.n_experts)                 # [T, K, E]
    # a dropped choice maps to the extra column `cap`, cut off: a zero row
    slot_onehot = F.one_hot(torch.where(keep, pos_in_expert, cap),
                            cap + 1)[..., :cap]               # [T, K, C]
    disp = torch.einsum("tke,tkc->tec", onehot.to(ht.dtype),
                        slot_onehot.to(ht.dtype))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(),
                        slot_onehot.float(), gate_vals * keep.float())
    xe = torch.einsum("td,tec->ecd", ht, disp)                # [E, C, D]
    ye = _expert_matmuls(xe, layer)
    return torch.einsum("ecd,tec->td", ye.float(), comb)


def _moe_experts_gather(ht, layer, c: MoEConfig, gate_idx, gate_vals, keep,
                        pos_in_expert, cap: int) -> torch.Tensor:
    """Gather-dispatch expert path (one expert shard): build the slot ->
    token index [E*C] with one small scatter, GATHER token rows into the
    expert banks, and combine by gathering each token's K slot outputs
    back: O(K·T·D) memory traffic instead of the einsum path's products.
    Returns [T, D] f32."""
    t, d = ht.shape
    n_slots = c.n_experts * cap
    flat_slot = gate_idx * cap + pos_in_expert                # [T, K]
    # dropped choices scatter into one dump slot past the end, cut off:
    # kept choices hold distinct slots, so only the dump slot sees
    # duplicate writes
    flat_slot = torch.where(keep, flat_slot, n_slots)
    tok_ids = torch.arange(t, device=ht.device)[:, None].expand_as(flat_slot)
    # empty slots read the zero pad row (index t): no valid-mask pass
    slot_tok = torch.full((n_slots + 1,), t, dtype=torch.long,
                          device=ht.device).scatter_(
        0, flat_slot.reshape(-1), tok_ids.reshape(-1))[:n_slots]
    ht_pad = torch.cat([ht, ht.new_zeros(1, d)])
    xe = ht_pad.index_select(0, slot_tok).reshape(c.n_experts, cap, d)
    ye = _expert_matmuls(xe, layer)
    # combine: each token gathers its K slot outputs (dropped choices read
    # slot 0 with weight 0) and sums them under its gate weights
    back = ye.reshape(n_slots, d).index_select(
        0, torch.where(keep, flat_slot, 0).reshape(-1))
    w = (gate_vals * keep.float())[..., None]                 # [T, K, 1]
    return (back.reshape(t, -1, d).float() * w).sum(dim=1)    # [T, D] f32


def moe_block(x: torch.Tensor, layer: dict, config: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (x + moe_out, aux_loss, z_loss).

    Top-k routing with a static per-expert capacity over the B*S tokens of
    the call; tokens over capacity are dropped (combine weight zero, the
    residual carries them). One device: the gather dispatch."""
    c = config
    b, s, d = x.shape
    h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    ht = h.reshape(b * s, d)
    (logits, probs, gate_vals, gate_idx, onehot, pos_in_expert, keep,
     cap) = _route(ht, layer["router"], c)
    out = _moe_experts_gather(ht, layer, c, gate_idx, gate_vals, keep,
                              pos_in_expert, cap)

    # -- aux losses (f32 scalars) --
    # Switch load-balance: E * sum_e(top-1 fraction routed · mean prob)
    frac = onehot[:, 0, :].float().mean(dim=0)
    aux = c.n_experts * (frac * probs.mean(dim=0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return x + out.reshape(b, s, d).to(x.dtype), aux, z


# ---- forward ----------------------------------------------------------------

def moe_forward(params: dict, tokens: torch.Tensor, config: MoEConfig,
                impl: str = "auto", sp=None, remat: str = "none",
                fsdp=None, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] f32, router_loss f32 scalar).

    router_loss = aux_weight * load_balance + z_weight * z_loss, summed over
    layers: the trainer adds it to the CE loss. Attention goes through
    ops/attention.py (the flash kernels on the card); remat as
    llama_forward. Not under an `sp` group: JAX routes the global token
    array (the capacity scan runs over every token), which a rank-local
    route would not; nor, for the same reason, under `fsdp` or `tp`."""
    if sharded(sp) or sharded(fsdp) or sharded(tp):
        raise NotImplementedError(
            "MoE over a group of ranks (sp, fsdp or tp > 1) is not yet "
            "ported to PyTorch: routing runs over the global token array")
    c = config
    lc = c.as_llama()
    s = tokens.shape[1]
    x = F.embedding(tokens, params["embed"])
    cos, sin = rope_frequencies(lc, torch.arange(s, device=tokens.device))

    def body(x, *weights):
        layer = dict(zip(_LAYER_KEYS, weights))
        x = _attention_block(x, layer, lc, cos, sin, impl)
        return moe_block(x, layer, c)

    step = remat_wrap(body, remat)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    stacks = [params["layers"][name].unbind(0) for name in _LAYER_KEYS]
    for weights in zip(*stacks):
        x, aux, z = step(x, *weights)
        aux_sum = aux_sum + aux
        z_sum = z_sum + z
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, weighted_router_loss(aux_sum, z_sum, c)

