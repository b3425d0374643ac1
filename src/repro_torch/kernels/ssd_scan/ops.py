"""Public SSD ops on the chunked (b, nc, ...) layout of
``models.ssm.ssd_chunked``: they fold (b, nc) into the kernel's b*nc axis and
dispatch on the tensor's device.

A CPU tensor goes to the plain version, which autograd differentiates; a CUDA
tensor to the kernels, which launch or raise.  The fused entry
``ssd_chunk_scan`` is differentiable on the card: when a gradient is wanted it
runs through ``_SSDChunkScanFn``, whose backward is the kernel of
``csrc/ssd_scan_bwd.cu``.  ``ssd_intra_chunk`` stays forward only, as the JAX
package's Pallas kernel is (ROADMAP C-2); no path differentiates it.  A meta
tensor (the dry-run's: shapes only) takes the plain versions' ops, which are
what its count reads; DTensors run ``ssd_chunk_scan``'s choice on their local
shards of the batch, every other dimension gathered first
(``repro_torch.dtensor.local_shards``).
"""

from __future__ import annotations

import torch

from repro_torch.dtensor import is_dtensor, local_shards

from . import ref
from .ssd_scan import ssd_chunk_scan as _scan_kernel
from .ssd_scan import ssd_chunk_scan_bwd as _scan_bwd_kernel
from .ssd_scan import ssd_intra_chunk as _kernel


def _flat(a):
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def _check_device(what, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: no implementation for device {device}")


class _SSDChunkScanFn(torch.autograd.Function):
    """The fused chunk scan on flattened (b*nc, ...) CUDA tensors, forward and
    backward kernels: (x, dt, cum, B, C, h_prev, D, nc, s, out_dtype) -> y."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, h_prev, D, nc, s, out_dtype):
        ctx.save_for_backward(x, dt, cum, B, C, h_prev, D)
        ctx.nc, ctx.s = nc, s
        return _scan_kernel(x, dt, cum, B, C, h_prev, D, nc, s, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        grads = _scan_bwd_kernel(*ctx.saved_tensors, dy.contiguous(), ctx.nc, ctx.s)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def ssd_intra_chunk(xc, dtc, cum, Bc, Cc) -> torch.Tensor:
    """xc (b, nc, Q, nh, hd); dtc/cum (b, nc, Q, nh); Bc/Cc (b, nc, Q, st).
    Returns y_intra (b, nc, Q, nh, hd) f32."""
    b, nc, Q, nh, hd = xc.shape
    x, dt, cm, B, C = (_flat(a) for a in (xc, dtc, cum, Bc, Cc))
    if xc.device.type in ("cpu", "meta"):
        y = ref.ssd_intra_chunk(x, dt, cm, B, C)
    else:
        if _wants_grad((x, dt, cm, B, C)):
            raise NotImplementedError(
                "ssd_intra_chunk has no backward kernel, as the JAX package's Pallas kernel "
                "has none: the differentiable entry is ssd_chunk_scan (csrc/ssd_scan_bwd.cu)")
        _check_device("ssd_intra_chunk", xc.device)
        y = _kernel(x, dt.float(), cm.float(), B, C)
    return y.reshape(b, nc, Q, nh, hd)


def ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The chunked SSD output: xc, dtc, cum, Bc, Cc as for
    :func:`ssd_intra_chunk`; h_prev (b, nc, nh, hd, st) f32, the state entering
    each chunk; D (nh,).  Returns y (b, s, nh, hd) in ``out_dtype``:
    y_intra + exp(cum) C . h_prev + D x over the first s rows, summed in f32
    and cast once."""
    if is_dtensor(xc):
        return local_shards(lambda *a: ssd_chunk_scan(*a, s, out_dtype),
                            [xc, dtc, cum, Bc, Cc, h_prev], (0,), [D])
    if xc.device.type in ("cpu", "meta"):
        return ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype)
    _check_device("ssd_chunk_scan", xc.device)
    return _kernel_path(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype)


def _kernel_path(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype=torch.float32):
    """:func:`ssd_chunk_scan` on the card: the forward kernel, through
    ``_SSDChunkScanFn`` when a gradient is wanted."""
    x, dt, cm, B, C, h = (_flat(a) for a in (xc, dtc, cum, Bc, Cc, h_prev))
    args = (x, dt.float(), cm.float(), B, C, h, D.float(), xc.shape[1], s, out_dtype)
    if _wants_grad((xc, dtc, cum, Bc, Cc, h_prev, D)):
        return _SSDChunkScanFn.apply(*args)
    return _scan_kernel(*args)
