"""Wrappers of the CUDA RoPE kernel (``csrc/rope.cu``), forward and backward.

Replaces no TPU kernel: the JAX package's RoPE (``src/repro/models/layers.py``
``apply_rope``) is plain jnp, which XLA fuses.  The kernel is that fusion for
the eager port: one launch rotates q and k, reading each value once and
writing it once, in f32 registers, rounded as the plain version's passes
round (the source's header gives the bound and the design).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().rope_apply
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wide_path(xs, ys, cos: torch.Tensor, sin: torch.Tensor) -> bool:
    """Whether every row takes 16-byte packs: dh/2 a whole number of packs,
    and every pointer and every (b, h, s) stride over more than one index 16
    bytes aligned (the tables' rows then are too)."""
    size = xs[0].element_size()
    if (xs[0].shape[-1] // 2) % (16 // size):
        return False
    return all(t.data_ptr() % 16 == 0 for t in (*xs, *ys, cos, sin)) and all(
        n == 1 or (st * size) % 16 == 0
        for t in (*xs, *ys) for n, st in zip(t.shape[:3], t.stride()[:3]))


def _check(xs, cos: torch.Tensor, sin: torch.Tensor, what: str) -> None:
    x = xs[0]
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"{what} kernel rotates one or two tensors, got {len(xs)}")
    if any(t.device != x.device for t in (*xs, cos, sin)) or x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in (*xs, cos, sin)]}")
    if x.dtype not in _build.DTYPE_CODES or any(t.dtype != x.dtype for t in xs):
        raise ValueError(f"{what} kernel takes float32/bfloat16 tensors of one dtype, got "
                         f"{[t.dtype for t in xs]}")
    if any(t.dim() != 4 or t.shape[0] != x.shape[0] or t.shape[2:] != x.shape[2:]
           for t in xs):
        raise ValueError(f"{what} kernel takes (b, h, s, dh) tensors alike but for h, got "
                         f"{[tuple(t.shape) for t in xs]}")
    b, _, s, dh = x.shape
    if dh % 2:
        raise ValueError(f"{what} kernel needs an even head dim, got {dh}")
    if any(t.stride(-1) != 1 for t in xs):
        raise ValueError(f"{what} kernel needs each tensor's last dimension contiguous")
    if any(t.shape[0] * t.shape[1] * s >= 2 ** 31 for t in xs):
        raise ValueError(f"{what} kernel takes fewer than 2**31 rows a tensor")
    for t in (cos, sin):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 3
                or t.shape[0] not in (1, b) or t.shape[1:] != (s, dh // 2)):
            raise ValueError(f"{what} kernel takes contiguous f32 cos and sin tables of "
                             f"(1 or {b}, {s}, {dh // 2}), got {t.dtype} {tuple(t.shape)}")


def _launch(xs, ys, cos, sin, backward: bool, what: str) -> None:
    q, qy = xs[0], ys[0]
    k, ky = (xs[1], ys[1]) if len(xs) == 2 else (None, None)
    b, hq, s, dh = q.shape
    strides = [*q.stride()[:3], *(k.stride()[:3] if k is not None else (0, 0, 0)),
               *qy.stride()[:3], *(ky.stride()[:3] if ky is not None else (0, 0, 0))]
    code = _fn()(
        q.data_ptr(), 0 if k is None else k.data_ptr(), qy.data_ptr(),
        0 if ky is None else ky.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        b, hq, 0 if k is None else k.shape[1], s, dh, cos.shape[0], *strides,
        wide_path(xs, ys, cos, sin), backward, _build.DTYPE_CODES[q.dtype], q.device.index,
        _build.stream_handle(q),
    )
    _build.check(code, what)


def rope(xs: list[torch.Tensor], cos: torch.Tensor, sin: torch.Tensor) -> list[torch.Tensor]:
    """Each of ``xs`` (one or two (b, h, s, dh) CUDA tensors, f32 or bf16, h
    their own, any strides with the last dimension contiguous) rotated by the
    angles whose cos and sin are the f32 (1 or b, s, dh/2) tables, in one
    launch; each result contiguous."""
    _check(xs, cos, sin, "rope")
    ys = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in xs]
    _launch(xs, ys, cos, sin, False, "rope")
    rope.launches += 1
    return ys


rope.launches = 0


def rope_bwd(gs: list[torch.Tensor], cos: torch.Tensor, sin: torch.Tensor,
             like: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients of ``rope``'s inputs from those of its outputs ``gs``, in
    one launch: each written in the layout of its tensor in ``like`` (the
    inputs' layouts, on any device), so that the view that made an input
    passes its gradient back without a copy."""
    _check(gs, cos, sin, "rope_bwd")
    if [tuple(m.shape) for m in like] != [tuple(g.shape) for g in gs]:
        raise ValueError(f"rope_bwd kernel needs a layout of each gradient's shape, got "
                         f"{[tuple(m.shape) for m in like]} for {[tuple(g.shape) for g in gs]}")
    ys = [torch.empty_strided(m.shape, m.stride(), dtype=g.dtype, device=g.device)
          for g, m in zip(gs, like)]
    _launch(gs, ys, cos, sin, True, "rope_bwd")
    rope_bwd.launches += 1
    return ys


rope_bwd.launches = 0
