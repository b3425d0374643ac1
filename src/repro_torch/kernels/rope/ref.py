"""Plain PyTorch RoPE: the version the kernel is held against, and the one a
CPU or meta tensor takes (``ops.rope``) or ``plain=True`` takes anywhere.

``rope_table`` builds the kernel's cos and sin tables with the same ops as
``apply_rope``, so that the angles are bit for bit the plain version's."""

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the angles, f32 (b, s, dh/2) for positions (b, s), or
    (1, s, dh/2) for positions (s,)."""
    freqs = rope_frequencies(head_dim, theta, device)           # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs               # (b, s, dh/2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, h, s, dh); positions: (b, s) or (s,).  Split-half rotation in f32."""
    cos, sin = rope_table(positions, x.shape[-1], theta, x.device)
    cos, sin = cos[:, None, :, :], sin[:, None, :, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
