"""Plain PyTorch RMSNorm: the version the kernel is held against."""

import torch


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    # a copy in f32 too, so that x enters the graph once and its gradient
    # comes back as one term: the same bits whether the norm runs on a plain
    # tensor or on a DTensor's local shard
    xf = x.to(torch.float32, copy=True)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * gamma.float()
    return y.to(x.dtype)
