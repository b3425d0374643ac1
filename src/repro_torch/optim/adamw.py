"""AdamW over the port's parameter trees (f32 moments whatever the parameter
dtype).  Port of ``src/repro/optim/adamw.py``.

The JAX package's update is pure.  Here ``adamw_update`` writes the new
moments and parameters into the tensors it is given and returns them: at
full width each model's parameters and moments are gigabytes, and a second
copy of them per step would double that.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: int
    m: object
    v: object


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """One AdamW step, in place (module docstring).  Returns (params, state)."""
    step = state.step + 1
    # the bias corrections in f32, as the JAX package computes them
    b1t = float(1.0 - np.float32(b1) ** np.float32(step))
    b2t = float(1.0 - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v))):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        delta = (m / b1t) / (torch.sqrt(v / b2t) + eps)
        if weight_decay:
            delta.add_(p.float(), alpha=weight_decay)
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr``, then a cosine decay to 0 at ``total``."""

    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * prog))

    return lr
