"""Wrappers of the CUDA gate-window kernels (``csrc/gate_window.cu``).

Replace ``src/repro/kernels/gate_window/gate_window.py::_stats_kernel`` and
``::_buffer_kernel``.  Both read the bool window bytes in place through their
strides, so a sliced view of the gate's buffer is taken as it is, and write the
ops contract's dtypes directly: int32 counts and bool flags, each output its
own ``torch.empty`` (one allocation carved into the four measured slower on
the host: ``chip_smoke.py`` [timings]).  The source's header says what bounds
them and how they are laid out on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: rows of a window the kernels take: a worker's count and its first and last
#: straggle row each fit one byte of the kernels' words
MAX_ROWS = 32


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.library(), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 4 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.bool or x.dim() != 3:
        raise ValueError(f"{what} kernel takes a bool (cells, rows, n) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] > MAX_ROWS:
        raise ValueError(f"{what} kernel takes at most {MAX_ROWS} rows, got {x.shape[1]}")


def wide_path(x: torch.Tensor) -> bool:
    """Whether the kernels read the bool (cells, rows, n) view ``x`` a run of 16
    workers at a time, one 16-byte load a row: its workers are adjacent and
    every row starts on 16 bytes.  Otherwise, and for a run that n cuts short,
    they read it byte by byte.  The gate's contiguous buffers at n = 256, their
    tails and the windows it concatenates all take the wide path."""
    return _wide(x.data_ptr(), x.shape, x.stride())


def _wide(ptr: int, shape, strides) -> bool:
    (cells, rows, _), (sc, sr, sw) = shape, strides
    return (sw == 1 and ptr % 16 == 0 and (sr % 16 == 0 or rows <= 1)
            and (sc % 16 == 0 or cells <= 1))


def _launch(name: str, x: torch.Tensor, B: int, outs) -> bool:
    cells, rows, n = x.shape
    ptr, strides = x.data_ptr(), x.stride()
    wide = _wide(ptr, x.shape, strides)
    code = _fn(name)(
        ptr, cells, rows, n, *strides, int(B), wide, *(o.data_ptr() for o in outs),
        x.device.index, _build.stream_handle(x),
    )
    _build.check(code, name)
    return wide


def window_stats(win: torch.Tensor, B: int):
    """(distinct, worker_max, round_max) int32 (cells,) and pair_bad bool (cells,)
    of a bool (cells, rows, n) CUDA tensor, any strides."""
    _check(win, "window_stats")
    cells = win.shape[0]
    outs = [torch.empty(cells, dtype=torch.int32, device=win.device) for _ in range(3)]
    outs.append(torch.empty(cells, dtype=torch.bool, device=win.device))
    if cells:
        window_stats.wide_launches += _launch("gate_window_stats", win, B, outs)
        window_stats.launches += 1
    return tuple(outs)


def buffer_stats(buf: torch.Tensor, B: int):
    """(bufact bool, bufcnt int32, mdmap bool) (cells, n) maps and pair_bad bool
    (cells,) of a bool (cells, kh, n) CUDA tensor, any strides; kh == 0 gives
    zeros (the kernel still runs and writes them)."""
    _check(buf, "buffer_stats")
    cells, _, n = buf.shape
    dev = buf.device
    outs = (torch.empty((cells, n), dtype=torch.bool, device=dev),
            torch.empty((cells, n), dtype=torch.int32, device=dev),
            torch.empty((cells, n), dtype=torch.bool, device=dev),
            torch.empty(cells, dtype=torch.bool, device=dev))
    if cells:
        buffer_stats.wide_launches += _launch("gate_buffer_stats", buf, B, outs)
        buffer_stats.launches += 1
    return outs


# launches, and those of them that took the wide path
window_stats.launches = window_stats.wide_launches = 0
buffer_stats.launches = buffer_stats.wide_launches = 0
