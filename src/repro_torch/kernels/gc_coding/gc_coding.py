"""Wrapper of the CUDA coded-combine kernel (``csrc/gc_coding.cu``).

Replaces ``src/repro/kernels/gc_coding/gc_coding.py::_combine_kernel``.  The
kernel is bound by device-memory bytes (read parts once, write out once); the
source's header says how its design keeps it there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().gc_coded_combine
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def coded_combine(parts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """weights @ parts in one pass.  parts: (k, D) contiguous CUDA tensor, f32 or
    bf16, any D; weights: (k,) contiguous f32 on the same device."""
    if parts.device.type != "cuda" or weights.device != parts.device:
        raise ValueError(f"coded_combine kernel needs CUDA tensors on one device, got "
                         f"parts on {parts.device}, weights on {weights.device}")
    if parts.dim() != 2 or weights.shape != (parts.shape[0],) or parts.shape[0] == 0:
        raise ValueError(f"coded_combine kernel takes parts (k, D) with k > 0 and weights "
                         f"(k,), got {tuple(parts.shape)} and {tuple(weights.shape)}")
    if parts.dtype not in _build.DTYPE_CODES or weights.dtype != torch.float32:
        raise ValueError(f"coded_combine kernel takes float32/bfloat16 parts and float32 "
                         f"weights, got {parts.dtype}, {weights.dtype}")
    if not (parts.is_contiguous() and weights.is_contiguous()):
        raise ValueError("coded_combine kernel needs contiguous parts and weights")
    k, d = parts.shape
    out = torch.empty(d, dtype=parts.dtype, device=parts.device)
    code = _fn()(
        parts.data_ptr(), weights.data_ptr(), out.data_ptr(), k, d,
        _build.DTYPE_CODES[parts.dtype], parts.device.index, _build.stream_handle(parts),
    )
    _build.check(code, "coded_combine")
    coded_combine.launches += 1
    return out


coded_combine.launches = 0
