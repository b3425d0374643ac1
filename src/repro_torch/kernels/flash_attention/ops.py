"""Public attention op: dispatches on the tensors' device.

A CPU tensor goes to the plain version, which autograd differentiates; a
CUDA tensor to the kernels at every sequence length, forward and backward
(``_AttentionFn``), which launch or raise.  A call that needs a gradient at a
head dim the backward does not take (256: ROADMAP B-2b) raises before the
forward launches.  The JAX package's fallback to its
dense reference below 128 and its padding to 128 follow from the TPU's block
shape, and the port keeps neither: the kernels mask ragged edges themselves.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import aligned16, check_bwd_head_dim
from .flash_attention import flash_attention as _kernel
from .flash_attention import flash_attention_bwd as _kernel_bwd


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, need_grad):
        ctx.causal, ctx.window = causal, window
        if not need_grad:
            return _kernel(q, k, v, causal=causal, window=window)
        check_bwd_head_dim(q.shape[-1])  # before the forward launches
        out, lse = _kernel(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or not aligned16(dout):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _kernel_bwd(q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no implementation for device {q.device}")
    # the log-sum-exp is written only when a backward can follow
    need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _AttentionFn.apply(q, k, v, causal, window, need_grad)
