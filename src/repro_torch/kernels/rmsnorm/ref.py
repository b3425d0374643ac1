"""Plain PyTorch RMSNorm: the version the kernel is held against."""

import torch


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * gamma.float()
    return y.to(x.dtype)
