"""Plain PyTorch SSD intra-chunk block: the version the kernel is held against
(a transcription of ``src/repro/kernels/ssd_scan/ref.py``)."""

import torch


def ssd_intra_chunk(x, dt, cum, B, C):
    """x (bc, Q, nh, hd); dt/cum (bc, Q, nh); B/C (bc, Q, st) -> (bc, Q, nh, hd) f32."""
    Q = x.shape[1]
    scores = torch.einsum("bqs,bus->bqu", C.float(), B.float())
    decay = torch.exp(cum[:, :, None, :].float() - cum[:, None, :, :].float())  # (bc,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # a select, not a product: decay may be inf above the diagonal
    w = torch.where(mask[None, :, :, None], scores[..., None] * decay, 0.0)
    xdt = x.float() * dt[..., None].float()
    return torch.einsum("bqun,bunh->bqnh", w, xdt)
