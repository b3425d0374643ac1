"""Assigned input shapes and meta-device input builders.

Port of ``src/repro/configs/shapes.py``.  Four global input shapes:
  train_4k     seq=4096    batch=256   train_step
  prefill_32k  seq=32768   batch=32    full-sequence forward (no grad)
  decode_32k   seq=32768   batch=128   serve_step: 1 token + decode cache
  long_500k    seq=524288  batch=1     serve_step, sub-quadratic only

``input_specs`` returns tensors on ``torch.device("meta")`` for every model
input, where the JAX package returns ``ShapeDtypeStruct``s: shapes and
dtypes, no storage.  ``skip_reason`` gives the same skips as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache, torch_dtype

META = torch.device("meta")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    """None if the (arch, shape) pair runs; else the documented skip."""
    if shape.mode == "decode" and not cfg.has_decode:
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return (
            "full quadratic attention; 500k decode requires a sub-quadratic "
            "path (SSM/hybrid recurrence or sliding window)"
        )
    if shape.mode == "prefill" and cfg.prefix_len and shape.seq_len <= cfg.prefix_len:
        return "sequence shorter than vision prefix"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict:
    """Meta tensors for the step function of ``shape.mode``.

    train/prefill -> batch dict for ``loss_fn`` / ``forward``;
    decode -> {"cache": ..., "token": ..., "pos": ...} for ``decode_step``.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg)

    if shape.mode in ("train", "prefill"):
        if cfg.frontend == "audio_stub":
            batch = {"frames": _meta((b, s, cfg.d_model), dt),
                     "labels": _meta((b, s), torch.int32)}
        elif cfg.frontend == "vision_stub":
            text = s - cfg.prefix_len
            batch = {"prefix_embeds": _meta((b, cfg.prefix_len, cfg.d_model), dt),
                     "tokens": _meta((b, text), torch.int32),
                     "labels": _meta((b, text), torch.int32)}
        else:
            batch = {"tokens": _meta((b, s), torch.int32),
                     "labels": _meta((b, s), torch.int32)}
        return {"batch": batch}

    return {
        "cache": init_cache(cfg, b, s, dtype=dt, device=META),
        "token": _meta((b, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }
