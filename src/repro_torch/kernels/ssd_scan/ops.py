"""Public SSD intra-chunk op on the chunked (b, nc, ...) layout of
``models.ssm.ssd_chunked``: folds (b, nc) into the kernel's b*nc axis and
dispatches on the tensor's device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel, which
launches or raises.  The kernel is forward only, as the JAX package's is
(ROADMAP C-2), so a CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import torch

from . import ref
from .ssd_scan import ssd_intra_chunk as _kernel


def ssd_intra_chunk(xc, dtc, cum, Bc, Cc) -> torch.Tensor:
    """xc (b, nc, Q, nh, hd); dtc/cum (b, nc, Q, nh); Bc/Cc (b, nc, Q, st).
    Returns y_intra (b, nc, Q, nh, hd) f32."""
    b, nc, Q, nh, hd = xc.shape

    def flat(a):
        return a.reshape((b * nc,) + a.shape[2:])

    x, dt, cm, B, C = (flat(a) for a in (xc, dtc, cum, Bc, Cc))
    if xc.device.type == "cpu":
        y = ref.ssd_intra_chunk(x, dt, cm, B, C)
    else:
        if torch.is_grad_enabled() and any(a.requires_grad for a in (x, dt, cm, B, C)):
            raise NotImplementedError(
                "ssd_intra_chunk has no backward kernel: training the ssm family on the card "
                "waits for its slice (ROADMAP.md: ssm training, an ssd_scan backward)"
            )
        if xc.device.type != "cuda":
            raise ValueError(f"ssd_intra_chunk: no implementation for device {xc.device}")
        y = _kernel(x, dt.float(), cm.float(), B, C)
    return y.reshape(b, nc, Q, nh, hd)
