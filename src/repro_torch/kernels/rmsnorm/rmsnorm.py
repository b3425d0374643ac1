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
from typing import NamedTuple

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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


#: the backward kernel's layout (csrc/rmsnorm_bwd.cu): blocks of 8 warps, at
#: most two an SM, all resident at once; 4 packs of 16 bytes a thread in a row
#: taken by a team of 1, 2, 4 or 8 warps (the bucket; 0 is the chunked path, for
#: wider rows and for views that cannot take 16-byte loads)
WARPS, BLOCKS_PER_SM, PACKS, BUCKETS = 8, 2, 4, (1, 2, 4, 8)


class Plan(NamedTuple):
    slabs: int            # blocks, each a contiguous slab of rows_per_slab rows
    rows_per_slab: int
    bucket: int           # warps a row on the register path; 0: chunked


def _plan(rows: int, d: int, vec: int, sm_count: int) -> Plan:
    """The backward's grid for a (rows, d) input read ``vec`` elements a pack
    (16 bytes; 1 where the view cannot take 16-byte loads)."""
    packs = -(-d // vec)
    bucket = 0
    if vec > 1:
        bucket = next((w for w in BUCKETS if packs <= 32 * w * PACKS), 0)
    rows_per_slab = max(1, -(-rows // (BLOCKS_PER_SM * sm_count)))
    return Plan(max(1, -(-rows // rows_per_slab)), rows_per_slab, bucket)


def _wide(d: int, itemsize: int, *ptrs: int) -> bool:
    """Whether rows of d elements at these pointers take 16-byte packs."""
    return d % (16 // itemsize) == 0 and all(p % 16 == 0 for p in ptrs)


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The backward's barrier counters for one device and stream.  Each launch
    leaves them 0 for the next; two streams never share them, since launches on
    two streams may overlap."""
    key = (device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _counters[key]


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dgamma) of ``rmsnorm`` for the output gradient dy, which has x's
    shape, dtype and layout.  dx has x's dtype, dgamma gamma's; both are reduced
    in f32, dgamma in a fixed order (no float atomics), the same bits in every
    call.  One launch, all blocks resident: they meet at a barrier on counters
    kept per device and stream (``_counter``) before adding dgamma's partial
    rows.  A launch that fails drops its device and stream's counters before
    raising."""
    _check(x, gamma, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"rmsnorm_bwd kernel needs dy like x, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    rows, d = x.shape
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    size = x.element_size()
    wide = _wide(d, size, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), gamma.data_ptr())
    plan = _plan(rows, d, 16 // size if wide else 1, _build.sm_count(x.device))
    partial = torch.empty((plan.slabs, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _counter(x.device, stream)
    code = _bwd_fn()(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), rows, d, plan.slabs, plan.rows_per_slab,
        plan.bucket, wide, eps, _build.DTYPE_CODES[x.dtype],
        _build.DTYPE_CODES[gamma.dtype], x.device.index, ctypes.c_void_p(stream),
    )
    if code:
        _counters.pop((x.device.index, stream), None)
    _build.check(code, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dgamma


rmsnorm_bwd.launches = 0
