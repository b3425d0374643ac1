"""The Mamba2 stack (the ssm family).

Each layer a pre-norm residual block as the port runs it: RMSNorm, an input
projection to [z | x B C | dt], a width-4 depthwise causal conv and SiLU, the
chunked SSD scan (one group, a scalar decay a head, a D skip), a gate by
SiLU(z), a gated RMSNorm and an output projection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...flops import step_launches
from ..model import CONV_K, dense, rmsnorm, run_layers, ssm_sizes

FAMILIES = ("ssm",)


def stack_spec(model: dict) -> list[tuple[str, tuple, str, float]]:
    d = model["d_model"]
    di, st, nh, _ = ssm_sizes(model)
    conv_dim = di + 2 * st
    spec = []
    for i in range(model["num_layers"]):
        pre = f"layers.{i}."
        spec += [
            (pre + "norm1.gamma", (d,), "ones", 0.0),
            dense(pre + "ssm.in_proj", d, 2 * di + 2 * st + nh),
            (pre + "ssm.conv_w", (CONV_K, conv_dim), "normal", 0.2),
            (pre + "ssm.conv_b", (conv_dim,), "zeros", 0.0),
            (pre + "ssm.A_log", (nh,), "zeros", 0.0),
            (pre + "ssm.D", (nh,), "ones", 0.0),
            (pre + "ssm.dt_bias", (nh,), "zeros", 0.0),
            (pre + "ssm.norm.gamma", (di,), "ones", 0.0),
            dense(pre + "ssm.out_proj", di, d),
        ]
    return spec


def ssd(x, dt, A, B, C, D, chunk: int, mm=torch.matmul):
    """The chunked SSD scan in f32.  x (b, s, nh, hd), dt (b, s, nh), A, D
    (nh,), B, C (b, s, st) -> y (b, s, nh, hd).  Its four products go
    through ``mm``."""
    b, s, nh, hd = x.shape
    st = B.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:  # dt 0 on the tail: it adds nothing to the state and decays nothing
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    xc, dtc = x.reshape(b, nc, Q, nh, hd), dt.reshape(b, nc, Q, nh)
    Bc, Cc = B.reshape(b, nc, Q, st), C.reshape(b, nc, Q, st)
    cum = torch.cumsum(dtc * A, dim=2)                                 # (b, nc, Q, nh)
    seg_end = cum[:, :, -1]
    # the chunk's state: sum_q exp(seg_end - cum_q) dt_q x_q B_q^T, (b, nc, nh, hd, st)
    weighted = xc * (torch.exp(seg_end[:, :, None] - cum) * dtc)[..., None]
    contrib = mm(weighted.permute(0, 1, 3, 4, 2), Bc[:, :, None])
    h = torch.zeros((b, nh, hd, st), dtype=x.dtype, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg_end[:, c])[:, :, None, None] + contrib[:, c]
    h_prev = torch.stack(h_prev, dim=1)                                # (b, nc, nh, hd, st)
    # within a chunk: y_q = sum_{u <= q} (C_q . B_u) exp(cum_q - cum_u) dt_u x_u; the
    # exponent is masked before exp (above the diagonal it is positive)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # (b, nc, Q, Q, nh)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))
    w = mm(Cc, Bc.transpose(-1, -2))[..., None] * decay                 # (b, nc, Q, Q, nh)
    y = mm(w.permute(0, 1, 4, 2, 3), (xc * dtc[..., None]).transpose(2, 3))  # (b, nc, nh, Q, hd)
    decay_in = torch.exp(cum).transpose(2, 3)[..., None]              # (b, nc, nh, Q, 1)
    y = y + mm(Cc[:, :, None], h_prev.transpose(-1, -2)) * decay_in
    y = y.transpose(2, 3).reshape(b, nc * Q, nh, hd)[:, :s]
    return y + x[:, :s] * D[:, None]


def ssm_block(p, pre, x, model, mm):
    b, s, _ = x.shape
    di, st, nh, hd = ssm_sizes(model)
    proj = mm(rmsnorm(x, p[pre + "norm1.gamma"]), p[pre + "ssm.in_proj"])
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * st], proj[..., 2 * di + 2 * st:]
    w, bias = p[pre + "ssm.conv_w"], p[pre + "ssm.conv_b"]
    padded = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    conv = sum(padded[:, i:i + s] * w[i] for i in range(CONV_K)) + bias
    xbc = F.silu(conv)
    xs, B, C = xbc[..., :di].reshape(b, s, nh, hd), xbc[..., di:di + st], xbc[..., di + st:]
    dt = F.softplus(dt + p[pre + "ssm.dt_bias"])
    A = -torch.exp(p[pre + "ssm.A_log"])
    y = ssd(xs, dt, A, B, C, p[pre + "ssm.D"], model.get("ssm_chunk", 64), mm)
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), p[pre + "ssm.norm.gamma"])
    return x + mm(y, p[pre + "ssm.out_proj"])


def stack(p, model: dict, x, mm, remat: bool):
    return run_layers(ssm_block, p, model, x, mm, remat)


def stack_ops(model: dict, seq: int) -> int:
    """Each layer's projections, its conv and the SSD scan's products over
    its chunks."""
    d = model["d_model"]
    di, st, nh, hd = ssm_sizes(model)
    Q = min(model.get("ssm_chunk", 64), seq)
    nc = -(-seq // Q)
    causal = Q * (Q + 1) // 2
    proj = 2 * seq * d * (2 * di + 2 * st + nh) + 2 * seq * di * d
    conv = 2 * seq * CONV_K * (di + 2 * st)
    ssd_ops = nc * (2 * st * causal             # C B^T over the causal pairs
                    + 2 * nh * hd * causal      # the intra-chunk output
                    + 2 * Q * nh * hd * st      # the chunk's state
                    + 2 * Q * st * nh * hd      # C . h_prev
                    + 2 * nh * hd * st)         # the recurrence
    return model["num_layers"] * (proj + conv + ssd_ops)


def launches_per_step(model: dict) -> dict[str, int]:
    """A layer: two norms (before the block and the gated norm) and one fused
    chunk scan."""
    L = model["num_layers"]
    return step_launches(norms=2 * L, scans=L)
