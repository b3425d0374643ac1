"""The attention stack: dense decoders and the audio encoder.

Each layer a pre-norm residual block as the port runs it: RMSNorm, split-half
RoPE on q and k, GQA attention with a causal mask or none (``causal``), an
optional q / k / v bias (``qkv_bias``); RMSNorm and a SwiGLU MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...flops import pairs, step_launches
from ..model import dense, head_dim, rmsnorm, run_layers

FAMILIES = ("dense", "audio")


def stack_spec(model: dict) -> list[tuple[str, tuple, str, float]]:
    d, f = model["d_model"], model["d_ff"]
    dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
    spec = []
    for i in range(model["num_layers"]):
        pre = f"layers.{i}."
        spec += [(pre + "norm1.gamma", (d,), "ones", 0.0),
                 dense(pre + "attn.wq", d, hq * dh), dense(pre + "attn.wk", d, hkv * dh),
                 dense(pre + "attn.wv", d, hkv * dh), dense(pre + "attn.wo", hq * dh, d)]
        if model.get("qkv_bias", False):
            for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
                spec.append((pre + f"attn.{name}", (width,), "zeros", 0.0))
        spec += [(pre + "norm2.gamma", (d,), "ones", 0.0), dense(pre + "mlp.w_gate", d, f),
                 dense(pre + "mlp.w_up", d, f), dense(pre + "mlp.w_down", f, d)]
    return spec


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


def stack(p, model: dict, x, mm, remat: bool):
    return run_layers(attention_block, p, model, x, mm, remat)


def stack_ops(model: dict, seq: int) -> int:
    """Each layer's q, k, v, o and MLP products and its scores and values
    over the query-key pairs."""
    d = model["d_model"]
    dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
    proj = 2 * seq * d * (hq + 2 * hkv) * dh + 2 * seq * hq * dh * d
    mlp = 2 * seq * 3 * d * model["d_ff"]
    attn = 2 * 2 * hq * dh * pairs(seq, model.get("causal", True))
    return model["num_layers"] * (proj + mlp + attn)


def launches_per_step(model: dict) -> dict[str, int]:
    """A layer: two norms and one attention call."""
    L = model["num_layers"]
    return step_launches(norms=2 * L, attention=L)
