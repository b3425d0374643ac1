"""Transformer layers of the dense family: RMSNorm, RoPE, GQA attention
(prefill and cached decode) and the SwiGLU MLP.

Port of ``src/repro/models/layers.py``.  Parameters are plain dicts of
tensors in the JAX package's layout: a dense weight is (d_in, d_out) and is
applied as ``x @ w``.  RMSNorm and training / prefill attention go through
the kernel ops, which pick the kernels (forward and backward) or the plain
version by the tensor's device; ``plain=True`` takes the plain version on any
device, through ordinary autograd, which is how a run on the card is held
against the same arithmetic without the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref

NEG_INF = -1e30


# -- init helpers -------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    return w.to(dtype)


# -- RMSNorm ------------------------------------------------------------------


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"gamma": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, plain: bool = False, eps: float = 1e-6):
    if plain:
        return rn_ref.rmsnorm(x, p["gamma"], eps=eps)
    return rn_ops.rmsnorm(x, p["gamma"], eps=eps)


# -- RoPE ---------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, h, s, dh); positions: (b, s) or (s,).  Split-half rotation in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)               # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs               # (b, s, dh/2)
    cos = torch.cos(angles)[:, None, :, :]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------


def multihead_attention(q, k, v, *, causal: bool, window: int = 0, plain: bool = False):
    if plain:
        return fa_ref.attention(q, k, v, causal=causal, window=window)
    return fa_ops.attention(q, k, v, causal=causal, window=window)


def attention_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, dh = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype),
        "wo": dense_init(gen, hq * dh, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, x, cfg, positions):
    """Returns q (b, hq, s, dh) and k, v (b, hkv, s, dh) as head-transposed views."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, dh).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg, *, positions=None, plain: bool = False):
    """Training / prefill path. x: (b, s, d).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = multihead_attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window, plain=plain
    )
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"], (k, v)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over leading batch dims, accumulated in f32 with an f32 result.

    On the card, cuBLAS takes bf16 operands in place (``out_dtype``).  The
    CPU has no such product, so there the operands are upcast first.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        return a.float() @ b.float()
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg):
    """Single-token decode against a KV cache, which it updates in place.

    x: (b, 1, d); cache_k/v: (b, hkv, S, dh); pos: current position (tokens
    < pos are valid).  Returns out (b, 1, d).  The products are plain
    ``torch.matmul`` as in the JAX package, which leaves them to XLA.
    """
    b = x.shape[0]
    dh = cfg.head_dim_
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache_k[:, :, pos] = k_new[:, :, 0]
    cache_v[:, :, pos] = v_new[:, :, 0]
    # GQA without materialising the repeat: fold the q heads into
    # (kv_head, group) and contract against the cache directly, in the
    # cache's dtype with f32 accumulation and f32 scores, as the JAX package
    # does (casting the whole cache to f32 would double its read traffic).
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, group, dh).to(cache_k.dtype)
    s = _f32_product(qg, cache_k.transpose(-1, -2)) * (dh ** -0.5)  # (b, hkv, g, S)
    k_pos = torch.arange(cache_k.shape[2], device=x.device)
    valid = k_pos <= pos
    if cfg.sliding_window > 0:
        valid &= (pos - k_pos) < cfg.sliding_window
    s = s.masked_fill(~valid, NEG_INF)
    pvals = torch.softmax(s, dim=-1)
    out = (pvals.to(cache_v.dtype) @ cache_v).to(x.dtype)           # (b, hkv, g, dh)
    out = out.reshape(b, 1, cfg.num_heads * dh)
    return out @ p["wo"]


# -- SwiGLU MLP ---------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def mlp_apply(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
