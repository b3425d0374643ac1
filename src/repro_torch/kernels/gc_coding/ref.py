"""Plain PyTorch coded combine: the version the kernel is held against."""

import torch

from repro_torch.tree import tree_map


def coded_combine(parts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """weights @ parts computed in f32, cast back to parts.dtype."""
    return (weights.float() @ parts.float()).to(parts.dtype)


def coded_combine_tree(tree, weights: torch.Tensor):
    """Leaf-wise combine of a tree whose leaves are stacked on a leading k axis."""
    w = weights.float()
    return tree_map(
        lambda leaf: torch.tensordot(w, leaf.float(), dims=1).to(leaf.dtype), tree
    )
