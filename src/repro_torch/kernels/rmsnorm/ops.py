"""Public RMSNorm: takes any (..., d) shape and dispatches on the tensor's device.

A CPU tensor goes to the plain version, which autograd differentiates; a CUDA
tensor to the kernels, forward and backward (``_RMSNormFn``), which launch or
raise.  A meta tensor (the dry-run's: shapes only) takes the plain version's
ops, which are what its count reads.  A DTensor runs the same choice on its
local shards, which hold whole rows: a sharded last dimension is gathered
first (``repro_torch.dtensor.local_shards``).
"""

from __future__ import annotations

import torch

from repro_torch.dtensor import is_dtensor, local_shards

from . import ref
from .rmsnorm import rmsnorm as _kernel
from .rmsnorm import rmsnorm_bwd as _kernel_bwd


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _kernel(x, gamma, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = _kernel_bwd(x, gamma, dy.contiguous(), eps=ctx.eps)
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if is_dtensor(x):
        return local_shards(lambda xl, gl: rmsnorm(xl, gl, eps=eps), [x],
                            range(x.dim() - 1), [gamma])
    if x.device.type in ("cpu", "meta"):
        return ref.rmsnorm(x, gamma, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no implementation for device {x.device}")
    shape = x.shape
    return _RMSNormFn.apply(x.reshape(-1, shape[-1]), gamma, eps).reshape(shape)
