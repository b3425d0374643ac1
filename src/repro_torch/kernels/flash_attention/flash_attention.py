"""Wrapper of the CUDA GQA flash-attention forward kernel
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel``
(forward only).  The source's header gives what bounds it and how its design
answers that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,   # (b, hq, sq, dh)
    k: torch.Tensor,   # (b, hkv, sk, dh)
    v: torch.Tensor,   # (b, hkv, sk, dh)
    *,
    causal: bool = True,
    window: int = 0,             # 0 = unlimited; else sliding window size
    valid_k: int | None = None,  # keys at positions >= valid_k are masked
) -> torch.Tensor:
    """Blocked online-softmax GQA attention on CUDA tensors.

    Inputs may be any strided views whose last dim is contiguous.  The output
    is a (b, hq, sq, dh) view of a (b, sq, hq, dh) buffer, so that merging the
    heads back into the model dim costs no copy.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (b,hq,sq,dh), k/v (b,hkv,sk,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention kernel needs CUDA tensors on one device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes one dtype of float32/bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention kernel needs a contiguous last dim")
    valid_k = sk if valid_k is None else valid_k
    if not 0 <= valid_k <= sk:
        raise ValueError(f"valid_k={valid_k} outside [0, {sk}]")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    code = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, sk, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), window, valid_k, dh ** -0.5,
        _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_handle(q),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
