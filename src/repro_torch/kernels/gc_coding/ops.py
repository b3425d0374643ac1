"""Public coded combine: dispatches on the tensors' device.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel, which
launches or raises; a meta tensor (shapes only) to the plain version's ops.  The JAX package pads D to a multiple of 128 for the TPU's
lanes; the CUDA kernel takes any D, so nothing is padded here.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.tree import tree_flatten, tree_unflatten

from . import ref
from .gc_coding import coded_combine as _kernel


def coded_combine(parts: torch.Tensor, weights) -> torch.Tensor:
    """weights @ parts for (k, D) stacked flat gradients, any D.  weights: (k,)
    values (a tensor, array or list), taken in f32."""
    if parts.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"coded_combine: no implementation for device {parts.device}")
    w = torch.as_tensor(weights, dtype=torch.float32, device=parts.device)
    if parts.device.type == "cuda":
        return _kernel(parts, w)
    return ref.coded_combine(parts, w)


def coded_combine_tree(tree, weights):
    """Combine a tree whose leaves are stacked on a leading k axis.

    Leaves (k, ...) -> leaves (...).  All leaves are raveled and concatenated
    into one (k, D_total) buffer, in the widest of their dtypes, so the kernel
    makes one pass over the whole gradient; that concatenation is one copy of
    the stacked tree.
    """
    leaves, spec = tree_flatten(tree)
    k = leaves[0].shape[0]
    wide = functools.reduce(torch.promote_types, [leaf.dtype for leaf in leaves])
    flat = torch.cat([leaf.to(wide).reshape(k, -1) for leaf in leaves], dim=1)
    combined = coded_combine(flat, weights)
    parts = torch.split(combined, [leaf[0].numel() for leaf in leaves])
    return tree_unflatten(spec, [
        part.reshape(leaf.shape[1:]).to(leaf.dtype) for part, leaf in zip(parts, leaves)
    ])
