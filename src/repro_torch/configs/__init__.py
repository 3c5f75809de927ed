"""Config registry: architecture id -> published and smoke configs."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import (ModelConfig, ServeConfig, TrainConfig,
                   dense_equivalent_pages, pages_for_tokens)

# the architectures the port runs so far: two dense decoders, the hybrid
# Mamba2 zamba2 and the RWKV6 rwkv6
ARCH_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


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


__all__ = ["ARCH_MODULES", "ModelConfig", "ServeConfig", "TrainConfig",
           "dense_equivalent_pages", "get_config", "get_smoke_config",
           "pages_for_tokens"]
