"""Model families of the workload runtime (PyTorch port).

Each family exposes the surface of gpu_docker_api_tpu/models: init_params,
forward(params, tokens, config, *, impl, mesh, remat) -> logits, and its
config class. Only the llama family is ported; asking for "moe" raises.
"""

from dataclasses import dataclass
from typing import Any, Callable

from . import llama as _llama
from .llama import LlamaConfig, init_params, llama_forward  # noqa: F401


@dataclass(frozen=True)
class ModelFamily:
    name: str
    init_params: Callable
    forward: Callable          # (params, tokens, config, *, impl, mesh, remat)
    config_cls: Any
    returns_extra_loss: bool = False


LLAMA = ModelFamily(
    name="llama",
    init_params=_llama.init_params,
    forward=_llama.llama_forward,
    config_cls=_llama.LlamaConfig,
)

FAMILIES = {f.name: f for f in (LLAMA,)}
NOT_YET_PORTED = ("moe",)

# named configs per family — what the workload CLI resolves --config against
NAMED_CONFIGS = {
    "llama": {"tiny": _llama.LlamaConfig.tiny,
              "mini": _llama.LlamaConfig.llama_mini,
              "250m": _llama.LlamaConfig.llama_250m,
              "1b": _llama.LlamaConfig.llama_1b,
              "llama3_8b": _llama.LlamaConfig.llama3_8b,
              "mistral_7b": _llama.LlamaConfig.mistral_7b},
}


def named_config(family: str, name: str):
    """Resolve a (family, config-name) pair; raises KeyError with the valid
    choices when unknown, NotImplementedError for a family not yet ported."""
    if family in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model family {family!r} is not yet ported to PyTorch")
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
