"""Plain PyTorch dense GQA attention with causal / sliding-window / valid_k
masks: the version the kernel is held against."""

from __future__ import annotations

import torch


def attention(
    q: torch.Tensor,   # (b, hq, sq, dh)
    k: torch.Tensor,   # (b, hkv, sk, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    valid_k: int | None = None,
) -> torch.Tensor:
    _, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * (dh ** -0.5)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < (sk if valid_k is None else valid_k)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & ((q_pos - k_pos) < window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    return out.to(q.dtype)
