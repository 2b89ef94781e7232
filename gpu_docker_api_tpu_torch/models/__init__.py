"""Model families of the workload runtime (PyTorch port).

Each family exposes the surface of gpu_docker_api_tpu/models: init_params,
forward(params, tokens, config, *, impl, sp, remat, fsdp, tp) -> logits (or
(logits, extra_loss) for MoE, whose router loss the trainer adds to CE, and
whose forward also takes ep and data: the expert-parallel group and the
group it routes over), its config class, param_shapes, the tree a
checkpoint or a converted tree is checked against, and param_kinds, each
leaf's sharding kind, which the trainer shards by (parallel/mesh rules).
"""

from dataclasses import dataclass
from typing import Any, Callable

from . import llama as _llama
from . import moe as _moe
from .llama import LlamaConfig, init_params, llama_forward  # noqa: F401


@dataclass(frozen=True)
class ModelFamily:
    name: str
    init_params: Callable
    forward: Callable          # (params, tokens, config, *, impl, sp, remat,
                               #  fsdp, tp[, ep, data])
    config_cls: Any
    param_shapes: Callable     # config -> {name: (shape, dtype)}
    param_kinds: Callable      # config -> {name: sharding kind}
    layer_keys: tuple          # the per-layer leaves, in the forward's order
    returns_extra_loss: bool = False


LLAMA = ModelFamily(
    name="llama",
    init_params=_llama.init_params,
    forward=_llama.llama_forward,
    config_cls=_llama.LlamaConfig,
    param_shapes=_llama.param_shapes,
    param_kinds=_llama.param_kinds,
    layer_keys=_llama._LAYER_KEYS,
)

MOE = ModelFamily(
    name="moe",
    init_params=_moe.init_params,
    forward=_moe.moe_forward,
    config_cls=_moe.MoEConfig,
    param_shapes=_moe.param_shapes,
    param_kinds=_moe.param_kinds,
    layer_keys=_moe._LAYER_KEYS,
    returns_extra_loss=True,
)

FAMILIES = {f.name: f for f in (LLAMA, MOE)}

# named configs per family — what both workload CLIs (train_llama, serve)
# resolve --family/--config against
NAMED_CONFIGS = {
    "llama": {"tiny": _llama.LlamaConfig.tiny,
              "mini": _llama.LlamaConfig.llama_mini,
              "250m": _llama.LlamaConfig.llama_250m,
              "1b": _llama.LlamaConfig.llama_1b,
              "llama3_8b": _llama.LlamaConfig.llama3_8b,
              "mistral_7b": _llama.LlamaConfig.mistral_7b},
    "moe": {"tiny": _moe.MoEConfig.tiny,
            "mini": _moe.MoEConfig.moe_mini,
            "1b": _moe.MoEConfig.moe_1b,
            "mixtral_8x7b": _moe.MoEConfig.mixtral_8x7b},
}


def named_config(family: str, name: str):
    """Resolve a (family, config-name) pair; raises KeyError with the valid
    choices when unknown."""
    table = NAMED_CONFIGS[family]
    if name not in table:
        raise KeyError(
            f"config {name!r} not defined for family {family!r} "
            f"(choices: {sorted(table)})")
    return table[name]()


def family_for(config) -> ModelFamily:
    """The family owning a config instance."""
    for fam in FAMILIES.values():
        if isinstance(config, fam.config_cls):
            return fam
    raise TypeError(f"no model family for config {type(config).__name__}")


def param_shapes(config) -> dict:
    """{name: (shape, dtype)} tree of the config's family's parameters."""
    return family_for(config).param_shapes(config)
