"""Models of the port: the dense, moe, ssm, hybrid, vlm and audio families."""

from .config import ModelConfig
from .transformer import (
    decode_step,
    embed_inputs,
    forward,
    generate,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    token_nll,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "forward",
    "embed_inputs",
    "init_cache",
    "decode_step",
    "prefill",
    "generate",
    "loss_fn",
    "token_nll",
]
