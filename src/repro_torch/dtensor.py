"""DTensor helpers shared by the models, the kernel ops and the launch tooling.

A sharding is written as DTensor placements: one ``Shard(d)`` or
``Replicate()`` for each axis of a ``DeviceMesh``.  The JAX package writes the
same choice per tensor dimension, as a ``PartitionSpec``; ``placements``
translates one into the other.

``local_shards`` runs a function on the local shards of DTensors when the
placements keep it local (the kernel ops' rule: a kernel sees whole rows, or
whole heads with their kv heads), and redistributes first where they do not, so
that every collective is an explicit one.  ``torch.distributed.tensor`` is
imported only when a DTensor is met, so that the models and kernels import
nothing of it on a plain path.
"""

from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements(mesh, spec) -> tuple:
    """The placements, one for each mesh axis, of the per-dimension ``spec``:
    an entry of ``spec`` is None (the dimension is whole), an axis name, or a
    tuple of names in mesh order (sharded over their product, the first the
    major one), as a ``PartitionSpec``'s entries are."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    # a mesh axis of one rank holds every dimension whole: it is written
    # Replicate, since DTensor refuses some views of a dimension "sharded" over
    # one rank (dropping a batch of 1)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"axes {axes} of dimension {dim} are not in the mesh's order "
                             f"{names}: DTensor shards a dimension major axis first")
        for i in at:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dimensions of {spec}")
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def split_dim(t, dim: int, size: int):
    """``t`` laid out so that its dimension ``dim`` can be viewed as (size,
    rest): where that dimension's shards do not split ``size`` evenly, they
    are gathered first, since a DTensor view cannot redistribute (the
    attention's (b, s, heads * dh) -> (b, s, heads, dh) with heads not a
    multiple of the model axis).  A plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % t.dim()
    plan, parts = [], 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            keep = size % (parts * t.device_mesh.size(i)) == 0
            parts *= t.device_mesh.size(i) if keep else 1
            p = p if keep else Replicate()
        plan.append(p)
    plan = tuple(plan)
    return t if plan == tuple(t.placements) else t.redistribute(t.device_mesh, plan)


class _GradInLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if grad.placements == ctx.placements:
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_in_layout(t):
    """``t``, whose gradient comes back laid out as ``t`` is.  Where a view's
    backward would split a dimension that the gradient has sharded unevenly
    (the attention's (b, s, heads * dh) output, its gradient sharded by the
    row-parallel wo), DTensor cannot redistribute inside the view; this
    gathers the gradient first.  A plain tensor is returned as it is."""
    return _GradInLayout.apply(t) if is_dtensor(t) else t


def rows_like(t, like):
    """``t`` (n, ...) laid out as the rows of the DTensor ``like`` (n, ...):
    sharded on dimension 0 where ``like`` is, whole elsewhere (a plain ``t``
    counts as whole).  The NLL's targets beside its log-probabilities, which
    ``loss_parallel`` takes only in that layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = like.device_mesh
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)
    plan = tuple(Shard(0) if p == Shard(0) else Replicate() for p in like.placements)
    return t.redistribute(mesh, plan)


def vocab_nll(logits, target):
    """Per-row NLL (N,) of DTensor ``logits`` (N, V) at ``target`` (N,), as
    ``nll_loss(log_softmax(logits), target, reduction="none")``.

    Where one mesh axis shards the vocabulary, the rows stay on their shards
    and the vocabulary is taken on that axis's 1-D submesh under
    ``loss_parallel`` (the caller's step runs in it,
    ``launch.sharding.step_context``): each rank holds its rows' logits of its
    slice of the vocabulary, and the log-softmax and the pick are sums across
    the axis.  torch's ``loss_parallel`` takes a 1-D mesh only in some
    versions, so it is given one.  Otherwise each rank takes its rows with the
    whole vocabulary (``local_shards``), outside ``loss_parallel``'s reach."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import torch.nn.functional as F

    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(1)]
    if len(vocab) != 1:
        return local_shards(
            lambda lg, t: F.nll_loss(torch.log_softmax(lg, dim=-1), t, reduction="none"),
            [logits, rows_like(target, logits)], (0,))
    (axis,) = vocab
    rows = tuple(Shard(1) if i == axis else (Shard(0) if p == Shard(0) else Replicate())
                 for i, p in enumerate(logits.placements))
    logits = logits.redistribute(mesh, rows)
    sub = mesh[mesh.mesh_dim_names[axis]]
    local = DTensor.from_local(logits.to_local(), sub, (Shard(1),))
    target = rows_like(target, logits).to_local()
    nll = F.nll_loss(torch.log_softmax(local, dim=-1),
                     DTensor.from_local(target, sub, (Replicate(),)), reduction="none")
    out = tuple(Replicate() if i == axis else p for i, p in enumerate(rows))
    return DTensor.from_local(nll.to_local(), mesh, out)


def _plan(tensors, dims) -> tuple:
    """Placements that keep, of the first tensor's, each ``Shard(d)`` with d in
    ``dims`` that every tensor in ``tensors`` has on the same mesh axis and
    that splits d evenly in all of them; ``Replicate()`` on every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tensors[0].device_mesh
    plan, parts = [], {}
    for i, p in enumerate(tensors[0].placements):
        keep = (isinstance(p, Shard) and p.dim in dims
                and all(t.placements[i] == p for t in tensors)
                and all(t.shape[p.dim] % (parts.get(p.dim, 1) * mesh.size(i)) == 0
                        for t in tensors))
        if keep:
            parts[p.dim] = parts.get(p.dim, 1) * mesh.size(i)
        plan.append(p if keep else Replicate())
    return tuple(plan)


def local_shards(fn, tensors, dims, params=()):
    """``fn(*local tensors, *local params)`` on DTensors, as a DTensor.

    ``tensors`` keep their shards on the dimensions in ``dims`` where all of
    them are sharded alike (``_plan``) and are redistributed to that plan
    first, which gathers every other sharded or pending-sum axis; ``params``
    (a norm's gamma, the SSM's D) are replicated.  ``fn``'s result has the
    first tensor's layout on ``dims`` and takes the plan.  Autograd runs
    through: the tensors' gradients come back on their shards, and a param's
    as a pending sum over the mesh axes that shard the tensors, since each
    shard adds its own rows' part of it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = tensors[0].device_mesh
    plan = _plan(tensors, dims)
    local = [t.redistribute(mesh, plan).to_local() for t in tensors]
    whole = (Replicate(),) * mesh.ndim
    grad = tuple(Replicate() if p == Replicate() else Partial() for p in plan)
    local += [p.redistribute(mesh, whole).to_local(grad_placements=grad) for p in params]
    return DTensor.from_local(fn(*local), mesh, plan)
