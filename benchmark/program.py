"""What the harness takes from the program (the PyTorch port): its config
classes, built from a configuration file's sizes. Imported only inside a
run, never by the reference."""

from __future__ import annotations

PACKAGE = "gpu_docker_api_tpu_torch"
INIT_STD = 0.02       # models/llama.init_from_shapes: every matrix N(0, 0.02)


def port_config(spec):
    """The program's config for a reference Spec. Raises where the program
    cannot state the configuration as the file does."""
    from gpu_docker_api_tpu_torch.models.llama import LlamaConfig
    from gpu_docker_api_tpu_torch.models.moe import MoEConfig
    common = dict(vocab_size=spec.vocab, d_model=spec.d_model,
                  n_layers=spec.n_layers, n_heads=spec.n_heads,
                  n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff,
                  max_seq_len=spec.max_seq_len, rope_theta=spec.rope_theta,
                  norm_eps=spec.norm_eps, dtype=spec.dtype)
    if spec.moe:
        if spec.window:
            raise ValueError("the program's MoE family has no window")
        cfg = MoEConfig(n_experts=spec.n_experts, top_k=spec.top_k,
                        capacity_factor=spec.capacity_factor,
                        router_aux_weight=spec.router_aux_weight,
                        router_z_weight=spec.router_z_weight, **common)
    else:
        cfg = LlamaConfig(sliding_window=spec.window, **common)
    if cfg.head_dim != spec.head_dim:
        raise ValueError(f"head_dim {spec.head_dim} != the program's "
                         f"{cfg.head_dim}")
    if spec.init_std != INIT_STD:
        raise ValueError(f"initializer_range {spec.init_std}: the program "
                         f"draws its weights N(0, {INIT_STD})")
    return cfg


def family_name(spec) -> str:
    """The program's family name (serve.py --family)."""
    return "moe" if spec.moe else "llama"
