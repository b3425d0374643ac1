"""Public gate-window statistics: dispatch on the tensor's device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernels, which
launch or raise.  A leading spec axis (specs, cells, rows, n) folds into the
cells axis with a reshape, so it is one launch.  Nothing is padded or converted:
the kernels read the bool bytes through their strides.  Unlike the JAX package,
which keeps its jnp reductions below ``n = 128`` workers, the card runs the
kernels at every ``n``.
"""

from __future__ import annotations

import torch

from . import ref
from .gate_window import buffer_stats as _buffer_kernel
from .gate_window import window_stats as _window_kernel


def _route(x: torch.Tensor, plain, kernel, B: int):
    if x.dtype != torch.bool or x.dim() not in (3, 4):
        raise ValueError(f"gate_window takes a bool (cells, rows, n) or (specs, cells, rows, "
                         f"n) tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain(x, B)
    if x.device.type != "cuda":
        raise ValueError(f"gate_window: no implementation for device {x.device}")
    return ref.fold_specs(kernel, x, B)


def window_stats(win: torch.Tensor, B: int):
    """``(distinct, worker_max, round_max, pair_bad)`` per cell: int32 counts and
    a bool flag (see ``ref.window_stats``)."""
    return _route(win, ref.window_stats, _window_kernel, B)


def buffer_stats(buf: torch.Tensor, B: int):
    """``(bufact, bufcnt, mdmap, pair_bad)``: bool / int32 / bool (cells, n) maps
    and a bool flag per cell (see ``ref.buffer_stats``)."""
    return _route(buf, ref.buffer_stats, _buffer_kernel, B)
