"""Plain PyTorch SSD chunk scan: the versions the kernel is held against.
``ssd_intra_chunk`` is a transcription of ``src/repro/kernels/ssd_scan/ref.py``;
``chunk_output`` adds the inter-chunk term, the D skip and the cast as
``src/repro/models/ssm.py`` writes them after the intra-chunk block."""

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


def chunk_output(y_intra, xc, cum, Cc, h_prev, D, s, out_dtype=torch.float32):
    """y (b, s, nh, hd) in ``out_dtype`` from y_intra (b, nc, Q, nh, hd) f32:
    y_intra + exp(cum) C . h_prev, then + D x, in f32, cast once."""
    b, nc, Q, nh, hd = xc.shape
    L = nc * Q
    y_inter = torch.einsum("bcqs,bcnhs->bcqnh", Cc.float(), h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, L, nh, hd)[:, :s]
    y = y + xc.float().reshape(b, L, nh, hd)[:, :s] * D[None, None, :, None]
    return y.to(out_dtype)


def ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype=torch.float32):
    """The chunked layout of ``ops.ssd_chunk_scan`` -> y (b, s, nh, hd)."""
    b, nc, Q, nh, hd = xc.shape

    def flat(a):
        return a.reshape((b * nc,) + a.shape[2:])

    y_intra = ssd_intra_chunk(flat(xc), flat(dtc), flat(cum), flat(Bc), flat(Cc))
    return chunk_output(y_intra.reshape(b, nc, Q, nh, hd), xc, cum, Cc, h_prev, D, s, out_dtype)
