"""Wrappers of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu`` forward,
``csrc/rmsnorm_bwd.cu`` backward).

Replaces ``src/repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel``, and adds
the backward that the JAX package leaves to ``jax.grad`` of its reference.
Both are bound by device-memory bytes; the sources' headers say how their
designs keep them there.
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


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.library().rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, gamma: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"{what} kernel needs CUDA tensors on one device, got "
                         f"x on {x.device}, gamma on {gamma.device}")
    if x.dim() != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"{what} kernel takes x (rows, d) and gamma (d,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.dtype not in _build.DTYPE_CODES or gamma.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {x.dtype}, {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x and gamma")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, d) contiguous CUDA tensor, f32 or bf16; gamma: (d,), f32 or bf16."""
    _check(x, gamma, "rmsnorm")
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


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dgamma) of ``rmsnorm`` for the output gradient dy, which has x's
    shape, dtype and layout.  dx has x's dtype, dgamma gamma's; both are reduced
    in f32, dgamma in a fixed order (no atomics)."""
    _check(x, gamma, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"rmsnorm_bwd kernel needs dy like x, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    rows, d = x.shape
    # slabs of rows for dgamma's partial sums: about 8 blocks per SM in all
    col_tiles = -(-d // 32)
    slabs = max(1, min(-(-rows // 64), 8 * _sm_count(x.device) // col_tiles))
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    partial = torch.empty((slabs, d), dtype=torch.float32, device=x.device)
    code = _bwd_fn()(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        rstd.data_ptr(), partial.data_ptr(), rows, d, slabs, eps,
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[gamma.dtype],
        x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dgamma


rmsnorm_bwd.launches = 0
