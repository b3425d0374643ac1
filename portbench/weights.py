"""The weights of each model, made on the device from ``--seed``: one draw
of a standard normal for all the random leaves of a model, in the type the
model is trained in, each leaf a view of it scaled in place.  The harness
hands them to the program and, drawn again, to the reference.

The leaves and their order are ``reference.model.param_spec``'s: the shared
leaves, then the layers' from the family's stack module
(``reference.stacks.stack_for``, its ``stack_spec``).  The draw is sliced in
that order, so a reordered spec changes every weight."""

from __future__ import annotations

import torch

from .feed import sub_seed
from .reference.model import is_f32_leaf, param_spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(model: dict, seed: int, index: int, device) -> dict[str, torch.Tensor]:
    """{leaf path: tensor} of model ``index`` (0, 1, ... of the interleaved
    models), in ``model["dtype"]`` but for the f32 leaves."""
    dtype = DTYPES[model["dtype"]]
    spec = param_spec(model)
    total = sum(torch.Size(shape).numel() for _, shape, init, _ in spec if init == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", index))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for path, shape, init, scale in spec:
        leaf_dtype = torch.float32 if is_f32_leaf(path) else dtype
        if init == "normal":
            n = torch.Size(shape).numel()
            out[path] = flat[off:off + n].view(shape).mul_(scale)
            off += n
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            out[path] = fill(shape, dtype=leaf_dtype, device=device)
    return out


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor of a nested dict / list, its path the keys
    and indices joined by dots (``layers.3.attn.wq``)."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from tree_paths(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_paths(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def load_into(tree, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the leaves of the program's parameter tree, in
    place; raises unless both have the same paths, shapes and dtypes."""
    leaves = dict(tree_paths(tree))
    if leaves.keys() != weights.keys():
        missing, extra = leaves.keys() - weights.keys(), weights.keys() - leaves.keys()
        raise ValueError(f"the program's parameters and the benchmark's differ: "
                         f"{sorted(missing)[:4]} not made, {sorted(extra)[:4]} not taken")
    for path, leaf in leaves.items():
        mine = weights[path]
        if leaf.shape != mine.shape or leaf.dtype != mine.dtype:
            raise ValueError(f"{path}: the program holds {tuple(leaf.shape)} {leaf.dtype}, "
                             f"the benchmark made {tuple(mine.shape)} {mine.dtype}")
        leaf.copy_(weights[path])
