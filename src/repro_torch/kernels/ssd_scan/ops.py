"""Public SSD ops on the chunked (b, nc, ...) layout of
``models.ssm.ssd_chunked``: they fold (b, nc) into the kernel's b*nc axis and
dispatch on the tensor's device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel, which
launches or raises.  The kernel is forward only, as the JAX package's is
(ROADMAP C-2), so a CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import torch

from . import ref
from .ssd_scan import ssd_chunk_scan as _scan_kernel
from .ssd_scan import ssd_intra_chunk as _kernel


def _flat(a):
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def _on_card(what, device, tensors) -> None:
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel: training the ssm and hybrid families on the "
            "card waits for ROADMAP.md B-3 (an ssd_scan backward) and A-7 (ssm training)"
        )
    if device.type != "cuda":
        raise ValueError(f"{what}: no implementation for device {device}")


def ssd_intra_chunk(xc, dtc, cum, Bc, Cc) -> torch.Tensor:
    """xc (b, nc, Q, nh, hd); dtc/cum (b, nc, Q, nh); Bc/Cc (b, nc, Q, st).
    Returns y_intra (b, nc, Q, nh, hd) f32."""
    b, nc, Q, nh, hd = xc.shape
    x, dt, cm, B, C = (_flat(a) for a in (xc, dtc, cum, Bc, Cc))
    if xc.device.type == "cpu":
        y = ref.ssd_intra_chunk(x, dt, cm, B, C)
    else:
        _on_card("ssd_intra_chunk", xc.device, (x, dt, cm, B, C))
        y = _kernel(x, dt.float(), cm.float(), B, C)
    return y.reshape(b, nc, Q, nh, hd)


def ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The chunked SSD output: xc, dtc, cum, Bc, Cc as for
    :func:`ssd_intra_chunk`; h_prev (b, nc, nh, hd, st) f32, the state entering
    each chunk; D (nh,).  Returns y (b, s, nh, hd) in ``out_dtype``:
    y_intra + exp(cum) C . h_prev + D x over the first s rows, summed in f32
    and cast once."""
    if xc.device.type == "cpu":
        return ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype)
    _on_card("ssd_chunk_scan", xc.device, (xc, dtc, cum, Bc, Cc, h_prev, D))
    x, dt, cm, B, C, h = (_flat(a) for a in (xc, dtc, cum, Bc, Cc, h_prev))
    return _scan_kernel(x, dt.float(), cm.float(), B, C, h, D.float(), xc.shape[1], s, out_dtype)
