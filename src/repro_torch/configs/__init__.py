"""Registry of the architectures the port runs.

The JAX package registers ten; the port lists only those whose family it
runs.  Asking for another raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "mamba2-1.3b": "mamba2_1_3b",
}

# architectures of the JAX package not yet runnable here -> ROADMAP item
_UNPORTED = {
    "llama3.2-1b": "A-2 (configs of the dense family)",
    "qwen2-72b": "A-2 (configs of the dense family)",
    "deepseek-67b": "A-2 (configs of the dense family)",
    "mixtral-8x22b": "A-8 (MoE family)",
    "qwen2-moe-a2.7b": "A-8 (MoE family)",
    "zamba2-2.7b": "A-8 (hybrid family: its shared attention has head_dim 80, and the "
                   "attention kernel takes 32, 64 or 128)",
    "paligemma-3b": "A-8 (vlm family)",
    "hubert-xlarge": "A-8 (audio family)",
}

ARCHS = list(_MODULES)


def _mod(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet; see ROADMAP.md {_UNPORTED[arch]}"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke"]
