"""Wrappers of the CUDA GQA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel``,
and adds the backward that the JAX package leaves to ``jax.grad`` of its jnp
path.  The sources' headers give what bounds them and how their designs
answer that.

Each C entry dispatches on the dtype: bf16, the dtype the model serves and
trains in, runs on the tensor cores (``mma.sync``, ``cp.async`` staging);
f32, the dtype of the logits and gradient checks, runs on the CUDA cores in
f32, as the JAX kernel contracts f32 inputs in f32.  The bf16 kernels move
16 bytes per copy, so their tensors must have 16-byte aligned rows
(:func:`aligned16`); the wrappers raise otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# head dims both directions are built for
HEAD_DIMS = (32, 64, 80, 128, 256)


def aligned16(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` that the kernels address starts 16-byte
    aligned: its data pointer, and each (b, h, s) stride over more than one
    index, in bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st * size) % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.library().flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    return_lse: bool = False,
):
    """Blocked online-softmax GQA attention on CUDA tensors.

    Inputs may be any strided views whose last dim is contiguous.  The output
    is a (b, hq, sq, dh) view of a (b, sq, hq, dh) buffer, so that merging the
    heads back into the model dim costs no copy.  With ``return_lse`` it
    returns (out, lse): lse is each row's f32 log-sum-exp of its scaled scores,
    (b, hq, sq), which the backward needs.
    """
    b, hq, sq, dh, hkv, sk, valid_k = _check(q, k, v, valid_k, "flash_attention")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    code = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, hq, hkv, sq, sk, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), window, valid_k, dh ** -0.5,
        _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_handle(q),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: torch.Tensor,    # the forward's output, (b, hq, sq, dh)
    lse: torch.Tensor,    # the forward's (b, hq, sq) f32 log-sum-exp
    dout: torch.Tensor,   # gradient of out
    *,
    causal: bool = True,
    window: int = 0,
    valid_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention``, from two launches (dQ, then dK/dV).

    Every tensor may be a strided view with a contiguous last dim.  The
    gradients have q's, k's and v's shapes and dtype, laid out as (b, s, h, dh)
    buffers seen through a transpose, as the forward's output is.
    """
    b, hq, sq, dh, hkv, sk, valid_k = _check(q, k, v, valid_k, "flash_attention_bwd")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be like q with a contiguous "
                             f"last dim, got {tuple(t.shape)} {t.dtype} strides {t.stride()}")
        _check_aligned(t, name, "flash_attention_bwd")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 (b, hq, sq), got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, hkv, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, sk, hkv, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, out, dout, lse, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 24)(
        *(st for t in (q, k, v, out, dout, dq, dk, dv) for st in t.stride()[:3])
    )
    code = _bwd_fn()(
        ptrs, delta.data_ptr(), strides, b, hq, hkv, sq, sk, dh,
        int(causal), window, valid_k, dh ** -0.5,
        _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_handle(q),
    )
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _check(q, k, v, valid_k, what):
    """(b, hq, sq, dh, hkv, sk, valid_k) of checked inputs; raises on what the
    kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what} takes q (b,hq,sq,dh), k/v (b,hkv,sk,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what} kernel needs CUDA tensors on one device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes one dtype of float32/bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what} kernel needs a contiguous last dim")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(t, name, what)
    valid_k = sk if valid_k is None else valid_k
    if not 0 <= valid_k <= sk:
        raise ValueError(f"valid_k={valid_k} outside [0, {sk}]")
    return b, hq, sq, dh, hkv, sk, valid_k


def _check_aligned(t, name, what):
    if t.dtype == torch.bfloat16 and not aligned16(t):
        raise ValueError(f"{what}: the bf16 kernel copies 16-byte rows, but {name} has data "
                         f"pointer {t.data_ptr()} and strides {t.stride()} (elements)")
