"""Public RoPE: rotates q and k together, dispatching on the tensors' device.

A CPU tensor goes to the plain version, which autograd differentiates; a CUDA
tensor to the kernel, forward and backward (``_RoPEFn``), one launch each way
for both tensors, which launch or raise.  The cos and sin tables are built once
a call, for both tensors, with the plain version's own ops (``ref.rope_table``).
A meta tensor (the dry-run's: shapes only) takes the plain version's ops, which
are what its count reads.  A DTensor runs the same choice on its local shards,
each tensor on its own, keeping the batch and the heads where they are sharded
(``repro_torch.dtensor.local_shards``); positions with a batch dimension are
split with the batch.
"""

from __future__ import annotations

import torch

from repro_torch.dtensor import is_dtensor, local_shards

from . import ref
from .rope import rope as _kernel
from .rope import rope_bwd as _kernel_bwd


class _RoPEFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cos, sin, *xs):
        ctx.save_for_backward(cos, sin)
        # the inputs' layouts, for the gradients (the projections' views)
        ctx.like = [torch.empty_like(x, device="meta") for x in xs]
        return tuple(_kernel(list(xs), cos, sin))

    @staticmethod
    def backward(ctx, *gs):
        cos, sin = ctx.saved_tensors
        gs = [g if g.stride(-1) == 1 else g.contiguous() for g in gs]
        return (None, None, *_kernel_bwd(gs, cos, sin, ctx.like))


def _rotate(xs: list[torch.Tensor], positions: torch.Tensor, theta: float) -> list:
    """``xs`` (plain tensors on one device) each rotated by ``positions``."""
    x = xs[0]
    if x.device.type in ("cpu", "meta"):
        return [ref.apply_rope(t, positions, theta) for t in xs]
    if x.device.type != "cuda":
        raise ValueError(f"rope: no implementation for device {x.device}")
    cos, sin = ref.rope_table(positions, x.shape[-1], theta, x.device)
    xs = [t if t.stride(-1) == 1 else t.contiguous() for t in xs]
    return list(_RoPEFn.apply(cos, sin, *xs))


def _sharded(x, positions: torch.Tensor, theta: float):
    """The DTensor ``x`` rotated on its local shards.  Positions (b, s) are
    laid out as x's batch (and heads, over which they repeat), so that each
    shard takes its own rows."""
    if positions.dim() == 1 or positions.shape[0] == 1:
        return local_shards(lambda xl: _rotate([xl], positions, theta)[0], [x], (0, 1))
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b, h, s, _ = x.shape
    mesh = x.device_mesh
    rows = DTensor.from_local(positions[:, None, :, None].expand(b, h, s, 1), mesh,
                              (Replicate(),) * mesh.ndim, run_check=False)
    rows = rows.redistribute(mesh, tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                                         else Replicate() for p in x.placements))
    return local_shards(lambda xl, pl: _rotate([xl], pl[:, 0, :, 0], theta)[0],
                        [x, rows], (0, 1))


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q (b, hq, s, dh) and k (b, hkv, s, dh) rotated by ``positions``, (s,)
    or (b, s): split-half, in f32, each result in its input's dtype."""
    if is_dtensor(q):
        return _sharded(q, positions, theta), _sharded(k, positions, theta)
    return tuple(_rotate([q, k], positions, theta))
