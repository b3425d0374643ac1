"""Step functions of the coded-training module.  Only the serve step is ported
so far; coded training is the port's next slice (ROADMAP.md A-6)."""

from __future__ import annotations

from repro_torch.models import decode_step
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, token, pos: int):
        return decode_step(params, cfg, cache, token, pos)

    return step
