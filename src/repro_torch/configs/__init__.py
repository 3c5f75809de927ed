"""Config registry: architecture id -> published and smoke configs."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import (ModelConfig, ServeConfig, TrainConfig,
                   dense_equivalent_pages, pages_for_tokens)

# every architecture of the JAX package: the dense decoders (the paper's
# own OPT and QWEN among them), the hybrid Mamba2 zamba2, the RWKV6 rwkv6,
# the whisper encoder-decoder, the MoE decoders olmoe and qwen3-moe and the
# vision-language llava
ARCH_MODULES: Dict[str, str] = {
    "llava-next-34b": "llava_next_34b",
    "granite-3-2b": "granite_3_2b",
    "gemma3-4b": "gemma3_4b",
    "granite-8b": "granite_8b",
    "olmo-1b": "olmo_1b",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "opt-6.7b": "opt_6_7b",
    "qwen-7b": "qwen_7b",
    "whisper-base": "whisper_base",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
}


# the architectures the dry run covers (the JAX package's ASSIGNED_ARCHS):
# every registered one but opt-6.7b and qwen-7b
ASSIGNED_ARCHS = [
    "llava-next-34b", "granite-3-2b", "gemma3-4b", "granite-8b", "olmo-1b",
    "whisper-base", "zamba2-2.7b", "qwen3-moe-235b-a22b", "olmoe-1b-7b",
    "rwkv6-1.6b",
]


def _module(arch: str):
    try:
        name = ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(ARCH_MODULES)}")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).get_config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).get_smoke_config()


__all__ = ["ARCH_MODULES", "ASSIGNED_ARCHS", "ModelConfig", "ServeConfig",
           "TrainConfig",
           "dense_equivalent_pages", "get_config", "get_smoke_config",
           "pages_for_tokens"]
