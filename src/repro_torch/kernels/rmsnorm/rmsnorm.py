"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel``.  The
kernel is bound by device-memory bytes (read x once, write y once); the
source's header says how its design keeps it there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, d) contiguous CUDA tensor, f32 or bf16; gamma: (d,), f32 or bf16."""
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, got "
                         f"x on {x.device}, gamma on {gamma.device}")
    if x.dim() != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel takes x (rows, d) and gamma (d,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.dtype not in _build.DTYPE_CODES or gamma.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"rmsnorm kernel takes float32/bfloat16, got {x.dtype}, {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and gamma")
    rows, d = x.shape
    y = torch.empty_like(x)
    code = _fn()(
        x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rows, d, eps,
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[gamma.dtype],
        x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
