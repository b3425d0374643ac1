"""Plain PyTorch SSD chunk scan: the versions the kernels are held against.
``ssd_intra_chunk`` is a transcription of ``src/repro/kernels/ssd_scan/ref.py``;
``chunk_output`` adds the inter-chunk term, the D skip and the cast as
``src/repro/models/ssm.py`` writes them after the intra-chunk block;
``ssd_chunk_scan_bwd`` is the fused chunk scan's backward written out as
formulas, as ``csrc/ssd_scan_bwd.cu`` computes them."""

import torch


def _causal(Q, device):
    return torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=device))


def _decay(cum):
    """exp(cum_q - cum_u) on and below the diagonal, 0 above it: (bc, Q, Q, nh).
    The exponent is masked before exp, never the result: above the diagonal it
    is positive and may overflow, and autograd of a product with inf (0 * inf)
    would put NaN into the gradient of cum."""
    diff = cum[:, :, None, :].float() - cum[:, None, :, :].float()
    mask = _causal(cum.shape[1], cum.device)[None, :, :, None]
    return torch.exp(torch.where(mask, diff, -torch.inf))


def ssd_intra_chunk(x, dt, cum, B, C):
    """x (bc, Q, nh, hd); dt/cum (bc, Q, nh); B/C (bc, Q, st) -> (bc, Q, nh, hd) f32."""
    scores = torch.einsum("bqs,bus->bqu", C.float(), B.float())
    w = scores[..., None] * _decay(cum)                       # (bc, Q, Q, nh), 0 masked
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


def ssd_chunk_scan_bwd(xc, dtc, cum, Bc, Cc, h_prev, D, s, dy):
    """Gradients of :func:`ssd_chunk_scan` for dy (b, s, nh, hd), in f32:
    (dx, ddt, dcum, dB, dC, dh_prev, dD), each in its input's layout; dx, dB
    and dC in the inputs' dtype, the rest f32.  Per batch-chunk and head, with
    S = C B^T, W = S * decay (0 above the diagonal), E = exp(cum) and
    y_inter = E (C . h_prev):

      dx      = dt (W^T dy) + D dy           ddt = sum_d x (W^T dy)
      dW      = dy (dt x)^T, masked          dS  = sum_heads dW * decay
      dB      = dS^T C                       dC  = dS B + sum_{heads,d} E dy h_prev
      dcum    = rowsum(dW * W) - colsum(dW * W) + sum_d dy y_inter
      dh_prev = sum_q E dy (x) C             dD  = sum dy x over the first s rows

    Rows q >= s get no dy, so every output row there is 0."""
    b, nc, Q, nh, hd = xc.shape
    L = nc * Q
    dyc = torch.zeros((b, L, nh, hd), dtype=torch.float32, device=xc.device)
    dyc[:, :s] = dy.float()
    dyc = dyc.reshape(b, nc, Q, nh, hd)
    x, dt, cm = xc.float(), dtc.float(), cum.float()
    B, C = Bc.float(), Cc.float()
    flat_cum = cm.reshape((b * nc, Q, nh))
    decay = _decay(flat_cum).reshape(b, nc, Q, Q, nh)
    S = torch.einsum("bcqs,bcus->bcqu", C, B)
    W = S[..., None] * decay                                          # (b, nc, Q, Q, nh)
    wt_dy = torch.einsum("bcqun,bcqnh->bcunh", W, dyc)
    dx = dt[..., None] * wt_dy + D.float()[:, None] * dyc
    ddt = (x * wt_dy).sum(-1)
    dW = torch.einsum("bcqnh,bcunh->bcqun", dyc, x * dt[..., None])
    dW = dW.masked_fill(~_causal(Q, xc.device)[None, None, :, :, None], 0.0)
    dS = (dW * decay).sum(-1)
    E = torch.exp(cm)
    G = torch.einsum("bcqnh,bcnhs->bcqns", dyc, h_prev.float())        # dy . h_prev
    dB = torch.einsum("bcqu,bcqs->bcus", dS, C)
    dC = torch.einsum("bcqu,bcus->bcqs", dS, B) + torch.einsum("bcqn,bcqns->bcqs", E, G)
    P = dW * W
    dcum = P.sum(3) - P.sum(2) + E * torch.einsum("bcqs,bcqns->bcqn", C, G)
    dh_prev = torch.einsum("bcqn,bcqnh,bcqs->bcnhs", E, dyc, C)
    dD = (dyc * x).sum((0, 1, 2, 4))
    return (dx.to(xc.dtype), ddt, dcum, dB.to(Bc.dtype), dC.to(Cc.dtype), dh_prev, dD)
