"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Port of ``src/repro/models/ssm.py``.  The sequence is split into chunks of
length Q; within a chunk the output is a masked quadratic form (the
intra-chunk part); across chunks a state of shape (heads, head_dim, d_state)
is carried by a loop over the chunks (the JAX package's ``lax.scan``).  On
the card the chunk's output, intra-chunk part, inter-chunk term and D skip,
is one ``ssd_scan`` kernel launch (``ssd_chunk_scan``), and its gradient one
call of the backward kernel; autograd differentiates the torch passes
around it (the pad, the cumsum, the chunk states, the recurrence).
``ssm_decode_step`` is the O(1) single-token recurrence.  Real scalar-per-head A, B/C shared
across heads (one group), a width-4 depthwise causal conv, as in the JAX
package.

``plain=True`` runs the plain versions (the chunk scan of
``kernels/ssd_scan/ref.py`` and the plain RMSNorm) on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

from .layers import _span, dense_init, rmsnorm_apply, rmsnorm_init

#: parameters kept in f32 whatever the model dtype (``src/repro/models/ssm.py:36-38``)
F32_PARAMS = ("A_log", "D", "dt_bias")
#: width of the causal conv; the decode cache holds the last CONV_K - 1 inputs
CONV_K = 4


def ssm_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, di, st, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    conv_dim = di + 2 * st
    return {
        # in_proj emits [z (di), x (di), B (st), C (st), dt (nh)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * st + nh, dtype),
        "conv_w": (torch.randn((CONV_K, conv_dim), generator=gen, device=dev) * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),   # A = -exp(A_log)
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(di, dtype, dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _causal_conv(x, w, b):
    """x: (b, s, c); w: (k, c) depthwise; left-padded causal conv."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _split_proj(cfg, proj):
    di, st = cfg.ssm_d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * st], proj[..., 2 * di + 2 * st:]


def _chunk_inputs(x, dt, A, B, C, chunk: int):
    """What the chunk's output needs, in the chunked layout: (xc, dtc, cum, Bc,
    Cc, h_prev, h_final).  The sequence is padded to whole chunks of Q =
    min(chunk, s); cum (b, nc, Q, nh) is the within-chunk cumsum of dt * A;
    h_prev (b, nc, nh, hd, st) f32 the state entering each chunk."""
    b, s, nh, hd = x.shape
    st = B.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:  # the padded tail has dt == 0: it neither adds to nor decays the state
        with _span("ssd.pad"):
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            B = F.pad(B, (0, 0, 0, pad))
            C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // Q

    xc = x.reshape(b, nc, Q, nh, hd)
    dtc = dt.reshape(b, nc, Q, nh)
    Bc = B.reshape(b, nc, Q, st)
    Cc = C.reshape(b, nc, Q, st)

    with _span("ssd.cum"):
        dA = dtc * A                                  # (b, nc, Q, nh) <= 0
        cum = torch.cumsum(dA, dim=2)                 # within-chunk cumsum
        seg_end = cum[:, :, -1, :]                    # total decay per chunk

    # chunk-final states: h_c = sum_u exp(seg_end - cum_u) dt_u B_u x_u^T
    with _span("ssd.contrib"):
        state_decay = torch.exp(seg_end[:, :, None, :] - cum)       # (b, nc, Q, nh)
        contrib = torch.einsum("bcqnh,bcqs->bcnhs", xc.float() * (state_decay * dtc)[..., None],
                               Bc.float())                           # (b, nc, nh, hd, st)

    # inter-chunk recurrence over nc: the state entering each chunk
    with _span("ssd.recurrence"):
        h = torch.zeros((b, nh, hd, st), dtype=torch.float32, device=x.device)
        h_prev = []
        for c in range(nc):
            h_prev.append(h)
            h = h * torch.exp(seg_end[:, c])[:, :, None, None] + contrib[:, c]
        h_prev = torch.stack(h_prev, dim=1)                          # (b, nc, nh, hd, st)
    return xc, dtc, cum, Bc, Cc, h_prev, h


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, plain: bool = False,
                return_state: bool = False, out_dtype: torch.dtype = torch.float32):
    """Chunked SSD scan.

    x:  (b, s, nh, hd)   inputs per head
    dt: (b, s, nh)       softplus'd step sizes, f32
    A:  (nh,)            negative decay rates
    B:  (b, s, st)       input projections (shared across heads)
    C:  (b, s, st)       output projections
    D:  (nh,)            skip
    returns y (b, s, nh, hd), summed in f32 and cast once to ``out_dtype``,
    and with ``return_state`` the final state (b, nh, hd, st) f32.

    The chunk states and the recurrence over the chunks run first; the
    chunk's output (intra-chunk block, inter-chunk term, D skip, cast) is then
    one ``ssd_chunk_scan`` call, the fused kernel on the card, or with
    ``plain`` its plain version (``kernels/ssd_scan/ref.py``).
    """
    s = x.shape[1]
    xc, dtc, cum, Bc, Cc, h_prev, h = _chunk_inputs(x, dt, A, B, C, chunk)
    # y[t] = y_intra[t] + C_t . exp(cum_t) h_prev + D x_t, with
    # y_intra[t] = C_t . sum_{u<=t} exp(cum_t - cum_u) dt_u B_u x_u
    with _span("ssd.chunk_scan"):
        if plain:
            y = ssd_ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype)
        else:
            y = ssd_ops.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, out_dtype)
    if return_state:
        return y, h
    return y


def ssm_apply(p, x, cfg, *, return_cache: bool = False, plain: bool = False):
    """Full-sequence Mamba2 block. x: (b, s, d) -> (b, s, d).

    With ``return_cache`` also returns (state (b, nh, hd, st) f32, conv_buf
    (b, 3, conv_dim)) ready for ``ssm_decode_step``: the prefill path."""
    b, s, _ = x.shape
    di, st, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"]
    z, xBC_pre, dt = _split_proj(cfg, proj)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(b, s, nh, hd)
    B = xBC[..., di:di + st]
    C = xBC[..., di + st:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    out = ssd_chunked(xs, dt, A, B, C, p["D"], chunk=cfg.ssm_chunk, plain=plain,
                      return_state=return_cache, out_dtype=x.dtype)
    y, state = out if return_cache else (out, None)
    y = y.reshape(b, s, di) * F.silu(z)
    y = rmsnorm_apply(p["norm"], y, plain=plain)
    y = y @ p["out_proj"]
    if return_cache:
        # conv buffer = the last CONV_K - 1 PRE-conv inputs, left-padded if s is shorter
        tail = xBC_pre[:, -(CONV_K - 1):, :]
        tail = F.pad(tail, (0, 0, CONV_K - 1 - tail.shape[1], 0))
        return y, state, tail
    return y


def ssm_decode_step(p, x, state, conv_buf, cfg, *, plain: bool = False):
    """O(1) single-token recurrence.

    x: (b, 1, d); state: (b, nh, hd, st) f32; conv_buf: (b, 3, conv_dim)
    holding the last 3 pre-conv inputs.  Returns (y, state, conv_buf), new
    tensors; the caller writes them into its cache.
    """
    b = x.shape[0]
    di, st, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = (x @ p["in_proj"])[:, 0]                                  # (b, proj_dim)
    z, xBC, dt = _split_proj(cfg, proj)
    window = torch.cat([conv_buf, xBC[:, None, :]], dim=1)           # (b, 4, c)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_buf = window[:, 1:]
    xBC = F.silu(conv_out)
    xs = xBC[..., :di].reshape(b, nh, hd).float()
    B = xBC[..., di:di + st].float()
    C = xBC[..., di + st:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])                       # (b, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                               # (b, nh)
    state = state * decay[:, :, None, None] + \
        (xs * dt[:, :, None])[..., None] * B[:, None, None, :]
    y = torch.einsum("bs,bnhs->bnh", C, state)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(b, di).to(x.dtype) * F.silu(z)
    y = rmsnorm_apply(p["norm"], y[:, None, :], plain=plain)
    return y @ p["out_proj"], state, conv_buf
