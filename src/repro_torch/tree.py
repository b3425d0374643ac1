"""Nested parameter trees: dicts and lists of tensors.

The port keeps parameters, gradients and optimizer moments as plain nested
dicts and lists (the JAX package's pytrees).  These helpers flatten such a
tree into its leaves in a fixed order and rebuild it from leaves.
"""

from __future__ import annotations


def tree_flatten(tree) -> tuple[list, object]:
    """(leaves in depth-first order, a spec that ``tree_unflatten`` takes)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(spec, leaves):
    return _build(spec, iter(leaves))


# Module-level recursion: a nested function that calls itself sits in a
# reference cycle with its closure, which would keep the leaves (a model's
# weights, a step's gradients) alive until Python's cycle collector runs.
def _flatten(t, leaves: list):
    if isinstance(t, dict):
        return {k: _flatten(v, leaves) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten(v, leaves) for v in t)
    leaves.append(t)
    return None


def _build(s, it):
    if isinstance(s, dict):
        return {k: _build(v, it) for k, v in s.items()}
    if isinstance(s, (list, tuple)):
        return type(s)(_build(v, it) for v in s)
    return next(it)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
