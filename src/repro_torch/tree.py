"""Nested parameter trees: dicts and lists of tensors.

The port keeps parameters, gradients and optimizer moments as plain nested
dicts and lists (the JAX package's pytrees).  These helpers flatten such a
tree into its leaves in a fixed order and rebuild it from leaves.
"""

from __future__ import annotations


def tree_flatten(tree) -> tuple[list, object]:
    """(leaves in depth-first order, a spec that ``tree_unflatten`` takes)."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return next(it)

    return build(spec)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
