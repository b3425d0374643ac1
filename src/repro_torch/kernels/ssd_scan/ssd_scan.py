"""Wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::_intra_kernel``, forward
only, as the JAX package has it.  The source's header says what bounds it and
how its design answers that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_CHUNK = 128       # Q, the rows of a chunk
MAX_HEAD_DIM = 128
MAX_STATE = 512
#: blocks in flight per SM that the head grouping aims for
BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def heads_per_block(bc: int, nh: int, sms: int) -> int:
    """Heads a block takes: enough blocks for BLOCKS_PER_SM on every SM, and
    as many heads per block as that allows, so the score tile is reused."""
    groups = min(nh, max(1, -(-BLOCKS_PER_SM * sms // max(bc, 1))))
    return -(-nh // groups)


def _check(x, dt, cum, B, C) -> None:
    ts = {"x": x, "dt": dt, "cum": cum, "B": B, "C": C}
    if any(t.device.type != "cuda" or t.device != x.device for t in ts.values()):
        raise ValueError("ssd_intra_chunk kernel needs CUDA tensors on one device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in ts.items()))
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"ssd_intra_chunk kernel takes x (bc, Q, nh, hd) and B, C (bc, Q, st), "
                         f"got {tuple(x.shape)} and {tuple(B.shape)}")
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    if dt.shape != (bc, Q, nh) or cum.shape != (bc, Q, nh) or C.shape != (bc, Q, st):
        raise ValueError(f"ssd_intra_chunk kernel: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    if x.dtype not in _build.DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_intra_chunk kernel takes x, B, C all float32 or all bfloat16, "
                         f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise ValueError(f"ssd_intra_chunk kernel takes dt and cum in float32, got "
                         f"{dt.dtype}, {cum.dtype}")
    if Q > MAX_CHUNK or hd > MAX_HEAD_DIM or st > MAX_STATE:
        raise ValueError(f"ssd_intra_chunk kernel takes Q <= {MAX_CHUNK}, head_dim <= "
                         f"{MAX_HEAD_DIM} and d_state <= {MAX_STATE}, got Q {Q}, head_dim "
                         f"{hd}, d_state {st}")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD output y (bc, Q, nh, hd), f32, on CUDA tensors.

    x (bc, Q, nh, hd) and B, C (bc, Q, st) all f32 or all bf16; dt, cum
    (bc, Q, nh) f32.  Any strides: the kernel reads through them.
    """
    _check(x, dt, cum, B, C)
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    y = torch.empty((bc, Q, nh, hd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_longlong * 16)(*x.stride(), *dt.stride(), *cum.stride(), *B.stride(),
                                       *C.stride())
    code = _fn()(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        bc, Q, nh, hd, st, heads_per_block(bc, nh, _sm_count(x.device)), strides,
        _build.DTYPE_CODES[x.dtype], x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "ssd_intra_chunk")
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0
