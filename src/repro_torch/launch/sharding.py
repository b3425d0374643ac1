"""Sharding rules: params / batches / caches -> DTensor placements.  Port of
``src/repro/launch/sharding.py``.

Best-effort divisible sharding: every rule proposes a preferred mesh axis per
dimension and falls back to replication when the dimension does not divide the
axis, which lets all ten architectures run on the same mesh without per-arch
tuning.  A rule's per-dimension choice is the JAX package's ``PartitionSpec``
entry for entry (``param_pspec`` returns it as a tuple); the ``*_shardings``
functions return it as placements, one for each mesh axis
(``repro_torch.dtensor.placements``), and ``place`` lays a tree out by them.

Parameter layout (dense/moe blocks follow the Megatron pattern):
  embed (V, d)        -> (model, None)        vocab-sharded
  head  (d, V)        -> (None, model)
  attn wq/wk/wv       -> (None, model)        column parallel
  attn wo             -> (model, None)        row parallel
  mlp w_gate/w_up     -> (None, model)
  mlp w_down          -> (model, None)
  moe expert weights  -> (None, None, model) for w_gate/w_up, (None, model,
                         None) for w_down: tensor-parallel experts
  ssm in_proj         -> (None, model), out_proj -> (model, None)
  norms / scalars     -> replicated

The port keeps its layers as a list of dicts where the JAX package stacks
them on a leading scan axis, which that package never shards: its ``lead =
(None,)`` is each layer's own leaf here, and the rules read the leaf's shape
as it is.
"""

from __future__ import annotations

import contextlib

from repro_torch.dtensor import placements
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWState

from .mesh import data_axes, model_axis


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _maybe(mesh, dim: int, axes):
    """axes if dim divides the mesh axes product, else None."""
    return axes if axes and dim % _axis_size(mesh, axes) == 0 else None


def param_pspec(path: tuple, leaf, cfg: ModelConfig, mesh) -> tuple:
    """Per-dimension spec of one parameter leaf (path = its keys)."""
    m = model_axis(mesh)
    name = path[-1]
    shape = leaf.shape

    def spec(*dims):
        return tuple(_maybe(mesh, shape[i], d) for i, d in enumerate(dims))

    if name == "embed":
        return spec(m, None)
    if name == "head":
        return spec(None, m)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        return spec(None, m)
    if name in ("wo", "w_down", "out_proj"):
        if len(shape) == 3:  # moe expert (E, f, d): shard f
            return spec(None, m, None)
        return spec(m, None)
    if name in ("bq", "bk", "bv"):
        return spec(m)
    if name == "router":
        return spec(None, None)
    # conv_w, conv_b, A_log, D, dt_bias, gamma, scalars
    return (None,) * len(shape)


def _moe_fix(path, leaf, cfg, mesh, base: tuple) -> tuple:
    """Expert tensors are 3D; re-route w_gate/w_up to (None, None, model)."""
    shape = leaf.shape
    if len(shape) == 3 and path[-1] in ("w_gate", "w_up"):
        return (None, None, _maybe(mesh, shape[2], model_axis(mesh)))
    return base


def _map_path(fn, tree, path=()):
    """The tree with each leaf replaced by ``fn(keys, leaf)``; keys are the
    dict keys on the way to it (list indices left out)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(fn, v, path) for v in tree]
    return fn(path, tree)


def params_shardings(cfg: ModelConfig, params, mesh):
    """Placements tree matching ``params`` (real or meta tensors)."""

    def one(path, leaf):
        spec = _moe_fix(path, leaf, cfg, mesh, param_pspec(path, leaf, cfg, mesh))
        return placements(mesh, spec)

    return _map_path(one, params)


def batch_shardings(cfg: ModelConfig, batch, mesh, *, profile: str = "tp"):
    """Batch tree: leading dim over (pod, data), or over ALL axes in the
    "fsdp" profile, where the model axis carries batch too and the
    (model-sharded) params are gathered per layer instead of the activations
    summed (the dry-run's §Perf variants)."""
    da = data_axes(mesh)
    if profile == "fsdp":
        m = model_axis(mesh)
        da = da + ((m,) if m else ())

    def one(_, leaf):
        lead = _maybe(mesh, leaf.shape[0], da)
        if lead is None and len(da) > 1:
            lead = _maybe(mesh, leaf.shape[0], da[:-1])  # drop model axis if ragged
        return placements(mesh, (lead,) + (None,) * (leaf.dim() - 1))

    return _map_path(one, batch)


def cache_shardings(cfg: ModelConfig, cache, mesh, *, mode: str = "auto"):
    """KV / SSM caches.

    kv cache (L, b, hkv, S, dh): batch over (pod,data); heads over model
    when divisible, else (mode="auto") sequence over model, or
    (mode="headdim") the head_dim over model, which keeps the cache write
    local at the cost of a sum after QK^T (§Perf variant for the decode
    shapes).  ssm state (L, b, nh, hd, st): batch over (pod,data), heads over
    model.  When b == 1 (long_500k) the data axes move to the sequence
    instead, so the cache still spreads across the pod.
    """
    da = data_axes(mesh)
    m = model_axis(mesh)

    def one(path, leaf):
        name = path[-1]
        s = leaf.shape
        if name in ("k", "v", "shared_k", "shared_v"):
            b, hkv, S, dh = s[1], s[2], s[3], s[4]
            if _maybe(mesh, b, da):
                heads = _maybe(mesh, hkv, m)
                if heads:
                    return placements(mesh, (None, da, heads, None, None))
                if mode == "headdim" and _maybe(mesh, dh, m):
                    return placements(mesh, (None, da, None, None, m))
                return placements(mesh, (None, da, None, _maybe(mesh, S, m), None))
            # b == 1: spread sequence across everything
            if _maybe(mesh, S, da + ((m,) if m else ())):
                return placements(mesh, (None, None, None, da + (m,), None))
            return placements(mesh, (None,) * 5)
        if name == "state":
            return placements(mesh, (None, _maybe(mesh, s[1], da), _maybe(mesh, s[2], m),
                                     None, None))
        if name == "conv":
            return placements(mesh, (None, _maybe(mesh, s[1], da), None, None))
        return placements(mesh, (None,) * len(s))

    return _map_path(one, cache)


def opt_shardings(cfg: ModelConfig, opt, mesh, params_sharding) -> AdamWState:
    """Adam moments mirror the parameter shardings.  The port's step count is
    a Python int, replicated by being one, so it has no placements."""
    return AdamWState(step=None, m=params_sharding, v=params_sharding)


def replicated(mesh) -> tuple:
    return placements(mesh, ())


def place(tree, shardings, mesh):
    """``tree``'s tensors as DTensors laid out by ``shardings`` (a tree of
    placements of the same structure; an AdamWState's step stays as it is).
    Every rank holds the whole tensor and keeps its shard
    (``distribute_tensor``); a meta tensor gives a meta DTensor."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, AdamWState):
        return AdamWState(step=tree.step, m=place(tree.m, shardings.m, mesh),
                          v=place(tree.v, shardings.v, mesh))
    if isinstance(tree, dict):
        return {k: place(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, s, mesh) for v, s in zip(tree, shardings)]
    return distribute_tensor(tree, mesh, shardings)


@contextlib.contextmanager
def step_context(params):
    """What a step on DTensor ``params`` runs under, forward and backward: the
    plain tensors the model makes (masks, positions, zeros) count as
    replicated (``implicit_replication``), and where the head is sharded on
    the vocabulary along one mesh axis, the NLL is taken on the vocabulary
    shards (``loss_parallel``, ``dtensor.vocab_nll``), where DTensor would
    otherwise hold the whole (b, s, vocab) gradient of its gather on every
    rank."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.parallel import loss_parallel

    head = params["head"] if "head" in params else params["embed"]
    vocab_dim = 1 if "head" in params else 0
    sharded = sum(p == Shard(vocab_dim) for p in head.placements) == 1
    with implicit_replication(), (loss_parallel() if sharded else contextlib.nullcontext()):
        yield
