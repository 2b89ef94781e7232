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

On one device moe_block takes the gather dispatch, as the JAX package does
for one expert shard (the one-hot einsum dispatch of its multi-shard path
is here too, with the same semantics). Over ranks it routes the global
token array, as JAX's jit-global moe_block does: `data` (every axis but
tp) exchanges each rank's per-(k, row, expert) choice counts, so the
capacity counts every token, each kept choice gets its global slot (the
exclusive prefix in JAX's order: k, row, sequence shard, position) and the
load-balance term takes global means (each rank returns its share of aux
and z; the shares sum over `data` to the reference's). Experts act row by
row, so a layer's output depends on the global keep, the gates, each
choice's expert and the bank alone: under `ep` the kept choices travel to
the owner of their expert's E/ep slice of the bank and back
(comm.exchange_rows, a variable-split all-to-all), without ep each rank
runs the gather path on its own kept choices at their global slots. Under
`fsdp` a bank's D dim is gathered at its use inside the layer body, under
`tp` its F dim is column-parallel in we1/we3 and row-parallel in we2 (the
experts' partial outputs summed over the group before the gates weigh
them), and the router is replicated, so tp ranks route alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.quant import qeinsum
from ..parallel import comm
from .llama import (
    LlamaConfig, _attention_block, embed_tokens, gather, head_logits,
    init_from_shapes, rms_norm, rope_frequencies, shard_positions, sharded,
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
    # attention under sp, as LlamaConfig.sp_attn ("ring" or "ulysses")
    sp_attn: str = "ring"

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
            norm_eps=self.norm_eps, dtype=self.dtype, sp_attn=self.sp_attn)

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
    """Sharding-kind tree (keys into parallel.mesh.param_sharding_rules):
    the banks cut over ep (experts), fsdp and tp, the f32 router whole on
    every rank."""
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

def weighted_router_loss(aux, z, config: MoEConfig):
    """The router objective added to CE: load-balance and z losses under
    their config weights (moe_forward applies it to the layer sums)."""
    return config.router_aux_weight * aux + config.router_z_weight * z


def block_counts(onehot: torch.Tensor, rows: int):
    """This rank's choices by block: onehot [T, K, E] of its T = rows *
    S_loc tokens (its rows of the batch, each its sequence shard) ->
    (oh [K, rows, E, S_loc] int32, each choice's exclusive count within
    its (k, row) block, alike, and the counts [K, rows, E]). The running
    count is taken along the last dim: a scan along a tensor's last dim
    runs in parallel on the card, where one down the K*T rows of a
    [K*T, E] tensor runs one thread an expert, serially."""
    t, k, e = onehot.shape
    oh = onehot.to(torch.int32).reshape(rows, t // rows, k, e).permute(
        2, 0, 3, 1).contiguous()
    within = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh
    return oh, within, oh.sum(dim=-1)


def place_blocks(oh, within, every, rank: int, n_sp: int):
    """Global positions from every rank's block counts.

    every [R, K, rows, E]: the counts of the R ranks of the routing group
    (gather_counts), which run row shard major, sequence shard minor
    (MeshGroups.data): rank j holds row shard j // n_sp and sequence
    shard j % n_sp. JAX ranks the global array [B*S] K-major, tokens
    row-major (t = row * S + position), so a choice's global position is
    what precedes it in the order (k, row, sequence shard, position): the
    exclusive prefix of the blocks before its own, plus its count within
    its block. -> (positions [T, K] int64 of this rank's (`rank`)
    choices, the top-1 count of each expert over every token [E])."""
    k, rows, e, s_loc = oh.shape
    n_rows = every.shape[0] // n_sp
    order = every.reshape(n_rows, n_sp, k, rows, e).permute(2, 0, 3, 1, 4)
    flat = order.reshape(-1, e).long()                        # (k, row, sp)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(k, n_rows, rows,
                                                         n_sp, e)
    row_shard, sp_rank = divmod(rank, n_sp)
    start = before[:, row_shard, :, sp_rank, :]               # [K, rows, E]
    pos = (within + start[..., None]) * oh                    # [K, rows, E, S]
    pos = pos.sum(dim=2).permute(1, 2, 0).reshape(rows * s_loc, k)
    return pos, flat.reshape(k, -1, e)[0].sum(dim=0)


def global_positions(onehot: torch.Tensor, rows: int, data=None,
                     n_sp: int = 1):
    """Each of this rank's choices' position within its expert's capacity
    in the GLOBAL token array, and the global top-1 counts: its
    block_counts exchanged over the routing group `data` (one all-gather;
    None: this call's tokens are the whole array) and placed
    (place_blocks)."""
    oh, within, counts = block_counts(onehot, rows)
    every = comm.gather_counts(counts, data)                  # [R, K, rows, E]
    return place_blocks(oh, within, every, data.rank if data else 0, n_sp)


def router_losses(logits, probs, frac, t_all: int, config: MoEConfig):
    """(aux, z) of the routing: the Switch load-balance term E * sum_e(top-1
    share · mean router probability) and the z loss mean(lse^2), both f32.
    `frac` is each expert's top-1 share of all t_all tokens; logits and
    probs may be one rank's T of them, which then gives its share: its
    probabilities' sum and its lse^2 sum over t_all, so the shares sum
    over the ranks to the global values (a product of two global means is
    not a mean of rank-local products)."""
    aux = config.n_experts * (frac * probs.sum(dim=0)).sum() / t_all
    z = torch.logsumexp(logits, dim=-1).square().sum() / t_all
    return aux, z


def _route(ht: torch.Tensor, router: torch.Tensor, config: MoEConfig,
           data=None, rows: int = 1, n_sp: int = 1):
    """Routing of ht [T, D] (f32 router [D, E]): (logits [T, E] f32, probs
    [T, E], gate_vals [T, K] renormalised, gate_idx [T, K] int64, frac [E]
    f32 (each expert's share of the top-1 choices), pos_in_expert [T, K],
    keep [T, K] bool, cap).

    The top k come from a stable descending sort: among equal
    probabilities the lower expert index comes first, as jax.lax.top_k
    orders them, so capacity ranks and drops are the reference's. cap, the
    positions and frac count every token of the routing group `data` (ht:
    this rank's `rows` rows of its sequence shard, one of n_sp; None: ht
    is every token) through global_positions, one code path for one rank
    and many."""
    c = config
    logits = ht.float() @ router                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :c.top_k], idx[:, :c.top_k]
    # Mixtral renormalizes the selected gates
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    onehot = F.one_hot(gate_idx, c.n_experts)                 # [T, K, E]
    t_all = ht.shape[0] * (data.size if data else 1)
    cap = c.capacity(t_all)
    pos_in_expert, top1 = global_positions(onehot, rows, data, n_sp)
    frac = top1.float() / t_all
    keep = pos_in_expert < cap
    return (logits, probs, gate_vals, gate_idx, frac, pos_in_expert, keep,
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
                        pos_in_expert, cap: int, tp=None) -> torch.Tensor:
    """Gather-dispatch expert path (one expert shard): build the slot ->
    token index [E*C] with one small scatter, GATHER token rows into the
    expert banks, and combine by gathering each token's K slot outputs
    back: O(K·T·D) memory traffic instead of the einsum path's products.
    Under `tp` the bank is this rank's F slice: each token's K outputs are
    partial sums, summed over the group before the gates weigh them.
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
    if sharded(tp):
        back = comm.reduce_from_group(back, tp)
    w = (gate_vals * keep.float())[..., None]                 # [T, K, 1]
    return (back.reshape(t, -1, d).float() * w).sum(dim=1)    # [T, D] f32


def _moe_experts_ep(ht, layer, c: MoEConfig, gate_idx, gate_vals, keep,
                    pos_in_expert, cap: int, ep, tp=None) -> torch.Tensor:
    """Expert-parallel dispatch: this rank's bank is experts [r*E/ep,
    (r+1)*E/ep) of the `ep` group (rank r). Each kept choice (its row of
    ht, its global slot) goes to its expert's owner, which lays the rows
    it receives at their slots of its [E/ep, cap, D] buffer (global slots
    are distinct, so any rank's choices fit), runs its bank and sends each
    row's output back, where the combine sums them under the gates as the
    gather path does. Counts first, then variable-split all-to-alls
    (comm.exchange_rows), on every rank even when it sends or receives
    nothing. Under `tp` the outputs that come back are partial sums, summed
    over the group before the gates weigh them. Returns [T, D] f32."""
    t, d = ht.shape
    k = gate_idx.shape[1]
    e_loc = c.n_experts // ep.size
    choice = keep.reshape(-1).nonzero().flatten()             # (t, k) flat
    expert = gate_idx.reshape(-1)[choice]
    order = torch.argsort(expert // e_loc, stable=True)       # by owner
    choice, expert = choice[order], expert[order]
    sent = torch.bincount(expert // e_loc, minlength=ep.size)
    send = sent.tolist()
    # what each peer sends follows from global_positions' gathered counts
    # too (a (k, row) block keeps clamp(cap - before, 0, count) of an
    # expert), but only through the data group's rank layout and only for
    # the route that made `keep`: the owners' own counts stay right for
    # any keep mask, at one all-to-all of ep integers
    recv = comm.exchange_counts(sent, ep).tolist()
    slot = (expert % e_loc) * cap + pos_in_expert.reshape(-1)[choice]
    slot = comm.exchange_rows(slot, send, recv, ep)           # owner's slots
    rows = comm.exchange_rows(ht.index_select(0, choice // k), send, recv, ep)
    n_slots = e_loc * cap
    # empty slots read the zero pad row (index len(rows))
    slot_row = torch.full((n_slots,), rows.shape[0], dtype=torch.long,
                          device=ht.device).scatter_(
        0, slot, torch.arange(rows.shape[0], device=ht.device))
    xe = torch.cat([rows, rows.new_zeros(1, d)]).index_select(
        0, slot_row).reshape(e_loc, cap, d)
    ye = _expert_matmuls(xe, layer).reshape(n_slots, d)
    back = comm.exchange_rows(ye.index_select(0, slot), recv, send, ep)
    if sharded(tp):
        back = comm.reduce_from_group(back, tp)
    # each token's K outputs (a dropped choice's a zero row, weight zero)
    full = back.new_zeros(t * k, d).index_copy(0, choice, back)
    w = (gate_vals * keep.float())[..., None]                 # [T, K, 1]
    return (full.reshape(t, k, d).float() * w).sum(dim=1)     # [T, D] f32


def moe_block(x: torch.Tensor, layer: dict, config: MoEConfig, data=None,
              sp=None, ep=None, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (x + moe_out, aux_loss, z_loss).

    Top-k routing with a static per-expert capacity over the B*S tokens of
    the call; tokens over capacity are dropped (combine weight zero, the
    residual carries them). One device: the gather dispatch.

    Over ranks x is this rank's rows and sequence shard and routing runs
    over the global batch through `data` (_route); aux and z are then
    this rank's shares, which sum over `data` to the global values. The
    experts run through the ep dispatch under `ep`, else the gather path
    on this rank's kept choices; under `tp` each rank's bank slice gives
    partial expert outputs, summed over the group."""
    c = config
    b, s, d = x.shape
    h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    ht = h.reshape(b * s, d)
    n_sp = sp.size if sharded(sp) else 1
    (logits, probs, gate_vals, gate_idx, frac, pos_in_expert, keep,
     cap) = _route(ht, layer["router"], c, data, b, n_sp)
    # the router sees ht as it is (its cotangent is whole on every tp
    # rank), the bank's F slice the copy whose cotangent sums over tp
    hx = comm.copy_to_group(ht, tp) if sharded(tp) else ht
    args = (hx, layer, c, gate_idx, gate_vals, keep, pos_in_expert, cap)
    out = (_moe_experts_ep(*args, ep, tp) if sharded(ep)
           else _moe_experts_gather(*args, tp))

    # -- aux losses (f32 scalars) --
    aux, z = router_losses(logits, probs, frac,
                           b * s * (data.size if data else 1), c)
    return x + out.reshape(b, s, d).to(x.dtype), aux, z


# ---- forward ----------------------------------------------------------------

def layer_body(config: MoEConfig, cos, sin, impl: str, sp=None, fsdp=None,
               tp=None, ep=None, data=None, shard_pools: bool = False):
    """One decoder layer: body(x, *weights) -> (x, aux, z), weights this
    rank's shards of one layer's leaves in _LAYER_KEYS order, gathered over
    `fsdp` inside the body. Routing runs over `data` (moe_block); with
    shard_pools each sequence shard of `sp` routes its own tokens (the
    pipelined trunk's pools, parallel/pipeline.py), else the sequence
    shards of a row route together."""
    c = config
    lc = c.as_llama()
    kinds = param_kinds(c)
    layer_kinds = [kinds["layers"][name] for name in _LAYER_KEYS]
    route_sp = None if shard_pools else sp

    def body(x, *weights):
        weights = gather(weights, layer_kinds, fsdp)
        layer = dict(zip(_LAYER_KEYS, weights))
        x = _attention_block(x, layer, lc, cos, sin, impl, sp, tp)
        return moe_block(x, layer, c, data, route_sp, ep, tp)
    return body


def moe_forward(params: dict, tokens: torch.Tensor, config: MoEConfig,
                impl: str = "auto", sp=None, remat: str = "none",
                fsdp=None, tp=None, ep=None, data=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] f32, router_loss f32 scalar).

    router_loss = aux_weight * load_balance + z_weight * z_loss, summed over
    layers: the trainer adds it to the CE loss. Attention goes through
    ops/attention.py (the flash kernels on the card); remat as
    llama_forward. Over ranks, as llama_forward: tokens are this rank's
    rows and, under `sp`, its [B, S/sp] shard; params its shards (banks
    cut over `ep`, `fsdp`, `tp`), gathered over fsdp inside each layer's
    body; under `tp` the logits are its vocab shard. Routing runs over
    `data` (every axis but tp; moe_block) and router_loss is this rank's
    share. Every rank calls together."""
    c = config
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, fsdp, tp)
    cos, sin = rope_frequencies(c.as_llama(),
                                shard_positions(s, sp, tokens.device))
    step = remat_wrap(layer_body(c, cos, sin, impl, sp, fsdp, tp, ep, data),
                      remat)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    stacks = [params["layers"][name].unbind(0) for name in _LAYER_KEYS]
    for weights in zip(*stacks):
        x, aux, z = step(x, *weights)
        aux_sum = aux_sum + aux
        z_sum = z_sum + z
    logits = head_logits(params, x, c, fsdp, tp)
    return logits, weighted_router_loss(aux_sum, z_sum, c)
