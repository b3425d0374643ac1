"""Public attention op: dispatches on the tensors' device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel at every
sequence length.  The JAX package's fallback to its dense reference below 128
and its padding to 128 follow from the TPU's block shape, and the port keeps
neither: the kernel masks ragged edges itself.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as _kernel


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no implementation for device {q.device}")
    return _kernel(q, k, v, causal=causal, window=window)
