"""Registry of the architectures the port runs: the JAX package's ten, in
its order."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, InputShape, input_specs, skip_reason

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-72b": "qwen2_72b",
    "paligemma-3b": "paligemma_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-67b": "deepseek_67b",
}

ARCHS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


__all__ = [
    "ARCHS",
    "SHAPES",
    "InputShape",
    "get_config",
    "get_smoke",
    "input_specs",
    "skip_reason",
]
