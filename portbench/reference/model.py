"""Plain f32 reference of the families the benchmark trains: the attention
stack (dense decoders and the audio encoder) and the Mamba2 stack.

Written from the architecture as the configuration states it and the port
runs it: pre-norm RMSNorm (eps 1e-6), split-half RoPE on q and k, GQA
attention with a causal mask or none, a SwiGLU MLP; a Mamba2 block of an
input projection to [z | x B C | dt], a width-4 depthwise causal conv and
SiLU, the chunked SSD scan (one group, a scalar decay a head, a D skip), a
gate by SiLU(z), a gated RMSNorm and an output projection; a final RMSNorm
and an untied head; an f32 log-softmax.  Every operation runs in f32 with
TF32 off.  It imports nothing of the port: parameters are a dict from the
port's leaf paths (``layers.3.attn.wq``) to tensors.

``mm`` is the one matrix product every projection, attention product and
SSD scan product goes through: ``torch.matmul`` for the reference, a
quantising product for the control (``train.fp8_matmul``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

ATTENTION_FAMILIES = ("dense", "audio")
SSM_FAMILIES = ("ssm",)
CONV_K = 4
EPS = 1e-6
#: the Mamba2 parameters kept in f32 whatever the model dtype
SSM_F32 = ("A_log", "D", "dt_bias")


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def ssm_sizes(model: dict) -> tuple[int, int, int, int]:
    """(d_inner, d_state, heads, head_dim) of a Mamba2 block."""
    di = model.get("ssm_expand", 2) * model["d_model"]
    hd = model.get("ssm_head_dim", 64)
    return di, model["ssm_state"], di // hd, hd


def param_spec(model: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, scale) of every leaf, in a fixed order.  ``init``
    is ``normal`` (scale times a standard normal), ``ones`` or ``zeros``;
    a path ending in one of ``SSM_F32`` is kept in f32."""
    d, V, fam = model["d_model"], model["vocab_size"], model["family"]
    spec = [("embed", (V, d), "normal", 0.02), ("final_norm.gamma", (d,), "ones", 0.0)]
    if not model.get("tie_embeddings", False):
        spec.append(("head", (d, V), "normal", d ** -0.5))

    def dense(path, d_in, d_out):
        spec.append((path, (d_in, d_out), "normal", d_in ** -0.5))

    for i in range(model["num_layers"]):
        pre = f"layers.{i}."
        spec.append((pre + "norm1.gamma", (d,), "ones", 0.0))
        if fam in ATTENTION_FAMILIES:
            dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
            dense(pre + "attn.wq", d, hq * dh)
            dense(pre + "attn.wk", d, hkv * dh)
            dense(pre + "attn.wv", d, hkv * dh)
            dense(pre + "attn.wo", hq * dh, d)
            if model.get("qkv_bias", False):
                for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
                    spec.append((pre + f"attn.{name}", (width,), "zeros", 0.0))
            spec.append((pre + "norm2.gamma", (d,), "ones", 0.0))
            dense(pre + "mlp.w_gate", d, model["d_ff"])
            dense(pre + "mlp.w_up", d, model["d_ff"])
            dense(pre + "mlp.w_down", model["d_ff"], d)
        elif fam in SSM_FAMILIES:
            di, st, nh, _ = ssm_sizes(model)
            conv_dim = di + 2 * st
            dense(pre + "ssm.in_proj", d, 2 * di + 2 * st + nh)
            spec += [
                (pre + "ssm.conv_w", (CONV_K, conv_dim), "normal", 0.2),
                (pre + "ssm.conv_b", (conv_dim,), "zeros", 0.0),
                (pre + "ssm.A_log", (nh,), "zeros", 0.0),
                (pre + "ssm.D", (nh,), "ones", 0.0),
                (pre + "ssm.dt_bias", (nh,), "zeros", 0.0),
                (pre + "ssm.norm.gamma", (di,), "ones", 0.0),
            ]
            dense(pre + "ssm.out_proj", di, d)
        else:
            raise NotImplementedError(f"no reference for the {fam} family")
    return spec


def is_f32_leaf(path: str) -> bool:
    return path.rsplit(".", 1)[-1] in SSM_F32


# -- layers --------------------------------------------------------------------


def rmsnorm(x, gamma):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * gamma


def rope(x, theta: float):
    """x (b, h, s, dh): split-half rotation at positions 0 .. s-1."""
    dh, s = x.shape[-1], x.shape[-2]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_block(p, pre, x, model, mm):
    b, s, _ = x.shape
    dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
    theta = model.get("rope_theta", 500_000.0)
    h = rmsnorm(x, p[pre + "norm1.gamma"])

    def heads(name, count):
        y = mm(h, p[pre + f"attn.w{name}"])
        if model.get("qkv_bias", False):
            y = y + p[pre + f"attn.b{name}"]
        return y.reshape(b, s, count, dh).transpose(1, 2)

    q, k, v = rope(heads("q", hq), theta), rope(heads("k", hkv), theta), heads("v", hkv)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scores = mm(q, k.transpose(-1, -2)) * dh ** -0.5
    if model.get("causal", True):
        keep = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
        scores = scores.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, s, hq * dh)
    x = x + mm(o, p[pre + "attn.wo"])
    h = rmsnorm(x, p[pre + "norm2.gamma"])
    up = F.silu(mm(h, p[pre + "mlp.w_gate"])) * mm(h, p[pre + "mlp.w_up"])
    return x + mm(up, p[pre + "mlp.w_down"])


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


def sequence_nll(p, model: dict, batch: dict, mm=torch.matmul, remat: bool = True):
    """Each sequence's mean NLL (b,), in f32: next-token for a causal
    model, per frame for the encoder.  Each layer is checkpointed when
    ``remat``, so that a full-depth model's backward fits."""
    fam = model["family"]
    if model.get("frontend", "none") == "audio_stub":
        x = batch["frames"].float()
    else:
        x = p["embed"][batch["tokens"]]
    block = attention_block if fam in ATTENTION_FAMILIES else ssm_block
    for i in range(model["num_layers"]):
        fn = lambda h, pre=f"layers.{i}.": block(p, pre, h, model, mm)  # noqa: E731
        x = checkpoint.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = rmsnorm(x, p["final_norm.gamma"])
    head = p["embed"].T if model.get("tie_embeddings", False) else p["head"]
    logits = mm(x, head)
    labels = batch["labels"]
    if model.get("causal", True):
        logits, labels = logits[:, :-1], labels[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean(dim=1)
