"""A model configuration file (configs/<name>.json) read into plain sizes.

The file holds the published `config.json` keys of the model (Hugging Face
names), with the keys cut for one chip changed and listed under `reduced`,
and the sizes the source does not give under `assumed`. Both the harness
(which builds the program's config from it) and the plain reference read
it through this module, which imports nothing of the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import torch

# model_type of the source config -> the family of decoder it describes
FAMILIES = {"mistral": "dense", "llama": "dense", "mixtral": "moe"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Spec:
    name: str
    family: str            # "dense" | "moe"
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    max_seq_len: int
    rope_theta: float
    norm_eps: float
    window: int            # 0: full causal attention
    dtype: torch.dtype     # the stored parameters' type
    init_std: float
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    router_aux_weight: float = 0.0
    router_z_weight: float = 0.0

    @property
    def moe(self) -> bool:
        return self.family == "moe"


def load(path: str, name: str = "") -> Spec:
    with open(path, encoding="utf-8") as f:
        return from_dict(json.load(f), name)


def from_dict(c: dict, name: str = "") -> Spec:
    """The sizes of a configuration file. Raises on a key the decoder here
    does not compute as the source states it."""
    family = FAMILIES[c["model_type"]]
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {c['hidden_act']}: only silu is built")
    if c.get("tie_word_embeddings", False):
        raise ValueError("tied embeddings are not built")
    assumed = c.get("assumed", {})
    heads = int(c["num_attention_heads"])
    head_dim = int(c.get("head_dim") or assumed.get("head_dim")
                   or c["hidden_size"] // heads)
    if head_dim * heads != c["hidden_size"]:
        raise ValueError("head_dim * heads must equal hidden_size")
    kw = {}
    if family == "moe":
        kw = dict(n_experts=int(c["num_local_experts"]),
                  top_k=int(c["num_experts_per_tok"]),
                  capacity_factor=float(assumed["capacity_factor"]),
                  router_aux_weight=float(c["router_aux_loss_coef"]),
                  router_z_weight=float(assumed["router_z_loss_coef"]))
    return Spec(
        name=name, family=family, vocab=int(c["vocab_size"]),
        d_model=int(c["hidden_size"]), n_layers=int(c["num_hidden_layers"]),
        n_heads=heads, n_kv_heads=int(c["num_key_value_heads"]),
        head_dim=head_dim, d_ff=int(c["intermediate_size"]),
        max_seq_len=int(c["max_position_embeddings"]),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        window=int(c.get("sliding_window") or 0),
        dtype=DTYPES[c["torch_dtype"]],
        init_std=float(c["initializer_range"]), **kw)


def leaf_shapes(s: Spec) -> list:
    """[(path, shape, dtype)] of the trained parameters in the order a
    seeded init draws them: matrices stored [in, out], decoder layers
    stacked on a leading [L] axis, norms and the router in float32."""
    f32, dt, n, d = torch.float32, s.dtype, s.n_layers, s.d_model
    lq, lkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    layers = [("attn_norm", (n, d), f32), ("wq", (n, d, lq), dt),
              ("wk", (n, d, lkv), dt), ("wv", (n, d, lkv), dt),
              ("wo", (n, lq, d), dt), ("mlp_norm", (n, d), f32)]
    if s.moe:
        e = s.n_experts
        layers += [("router", (n, d, e), f32),
                   ("we1", (n, e, d, s.d_ff), dt),
                   ("we3", (n, e, d, s.d_ff), dt),
                   ("we2", (n, e, s.d_ff, d), dt)]
    else:
        layers += [("w1", (n, d, s.d_ff), dt), ("w3", (n, d, s.d_ff), dt),
                   ("w2", (n, s.d_ff, d), dt)]
    return ([("embed", (s.vocab, d), dt)]
            + [(f"layers.{k}", shape, t) for k, shape, t in layers]
            + [("final_norm", (d,), f32), ("lm_head", (d, s.vocab), dt)])


def n_params(s: Spec) -> int:
    total = 0
    for _, shape, _ in leaf_shapes(s):
        k = 1
        for x in shape:
            k *= x
        total += k
    return total
