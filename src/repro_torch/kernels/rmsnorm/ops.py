"""Public RMSNorm: takes any (..., d) shape and dispatches on the tensor's device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel, which
launches or raises.
"""

from __future__ import annotations

import torch

from . import ref
from .rmsnorm import rmsnorm as _kernel


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.rmsnorm(x, gamma, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no implementation for device {x.device}")
    shape = x.shape
    return _kernel(x.reshape(-1, shape[-1]), gamma, eps=eps).reshape(shape)
