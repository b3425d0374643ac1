"""Plain PyTorch gate-window statistics: the versions the kernels are held against.

Same contract as ``ops``: a bool (cells, rows, n) window, or (specs, cells,
rows, n) with the spec axis folded into cells.  ``.calls`` counts the calls, so
that a CPU run can be set beside the kernels' launch counts of a run on the card.
"""

from __future__ import annotations

import torch


def fold_specs(call, x: torch.Tensor, B: int):
    """Run ``call`` on a 3-D window, or on a 4-D one with its leading spec axis
    folded into cells (a reshape), unfolding every output."""
    if x.dim() == 3:
        return call(x, B)
    S, C = x.shape[:2]
    outs = call(x.reshape((S * C,) + tuple(x.shape[2:])), B)
    return tuple(o.reshape((S, C) + tuple(o.shape[1:])) for o in outs)


def _max0(x: torch.Tensor) -> torch.Tensor:
    """Row maximum of non-negative counts, 0 for an empty row."""
    if x.shape[1] == 0:
        return x.new_zeros(x.shape[0])
    return x.amax(dim=1)


def _pair_bad(x: torch.Tensor, B: int) -> torch.Tensor:
    """Same-worker straggle pair d >= B rows apart (d >= 1, as the JAX
    package's ``win[:, :-d]`` slice is empty at d = 0)."""
    bad = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for d in range(max(B, 1), x.shape[1]):
        bad |= (x[:, :-d] & x[:, d:]).any(dim=2).any(dim=1)
    return bad


def _window_stats(win: torch.Tensor, B: int):
    per_worker = win.sum(dim=1, dtype=torch.int32)
    return (
        win.any(dim=1).sum(dim=1, dtype=torch.int32),
        _max0(per_worker),
        _max0(win.sum(dim=2, dtype=torch.int32)),
        _pair_bad(win, B),
    )


def _buffer_stats(buf: torch.Tensor, B: int):
    kh = buf.shape[1]
    act = buf.any(dim=1)
    md = buf[:, : kh - B + 1].any(dim=1) if kh >= B else torch.zeros_like(act)
    return act, buf.sum(dim=1, dtype=torch.int32), md, _pair_bad(buf, B)


def window_stats(win: torch.Tensor, B: int):
    """(distinct, worker_max, round_max) int32 and pair_bad bool, per cell:
    workers straggling anywhere in the window, the most rounds one worker
    straggles, the most stragglers in one round, and a same-worker straggle
    pair >= ``B`` rounds apart."""
    window_stats.calls += 1
    return fold_specs(_window_stats, win, B)


def buffer_stats(buf: torch.Tensor, B: int):
    """(bufact bool, bufcnt int32, mdmap bool) per-worker maps and pair_bad
    bool per cell of a committed buffer (cells, kh, n): the worker straggles
    in the buffer, how often, whether in rows 0..kh-B (a pair >= ``B`` apart
    with the next row), and a >= ``B``-apart pair inside the buffer."""
    buffer_stats.calls += 1
    return fold_specs(_buffer_stats, buf, B)


window_stats.calls = 0
buffer_stats.calls = 0
