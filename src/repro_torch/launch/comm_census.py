"""Per-rank census of a traced step: its collectives, operations, bytes and
live memory.  The counterpart of ``src/repro/launch/hlo_census.py``, which
parses the collectives out of a compiled SPMD module's HLO text; here there is
no HLO, and ``RankCounter`` watches the step run.

``RankCounter`` is a ``TorchDispatchMode`` that sees what rank 0 runs.  An op
on DTensors is handed on to DTensor (the mode returns ``NotImplemented`` for
it), which redistributes its inputs and runs the op on its local shards; those
local ops, the collectives among them, come back through the mode, which counts
them:

* each ``_c10d_functional`` / ``_dtensor`` collective, with its kind and its
  result bytes on one rank (``census``, the JAX package's dict);
* the operations of each local matrix product, convolution or attention op,
  by ``torch.utils.flop_counter``'s formulas (elementwise work is not counted);
* the bytes each local op moves, its tensor inputs read once and its outputs
  written once (views, ``empty`` and collectives move none here);
* the bytes of the storages the step creates that are alive at once, and
  their peak (``temp_bytes``), each storage freed when its last tensor goes.

DTensor's sharding propagation runs ops on fake tensors to learn shapes; those
run under the fake mode and are not counted.  Replicated work is counted in
full, as every rank that holds the replica does it; a DTensor op that runs no
local op (a view that stays lazy) counts nothing.
"""

from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))
_NAMESPACES = ("_c10d_functional", "_dtensor")
_SKIP = ("wait_tensor", "_wrap_tensor_autograd")
_NO_BYTES = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
             torch.ops.aten.detach.default}


def _collective_kind(func) -> str | None:
    """The JAX package's name for a collective op, its own name for another
    collective, None for an op that is not a collective."""
    ns, _, name = func._schema.name.partition("::")
    if ns not in _NAMESPACES or name in _SKIP:
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return name


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (named ones too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on this rank: a DTensor's local shard."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankCounter(TorchDispatchMode):
    """Counts what rank 0 runs inside the block (module docstring).  The
    storages of ``args`` (the step's arguments, DTensors or plain) were there
    before it and are not temporaries, also where the step updates them in
    place."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        # (kind, result bytes, result shapes) of each collective, in order
        self.collectives: list[tuple[str, int, tuple]] = []
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._args = [(t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
                      for t in _tensors(args)]
        self._arg_ids = {id(s) for s in self._args}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out   # DTensor's sharding propagation, learning shapes
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives.append((kind, sum(_nbytes(t) for t in outs),
                                     tuple(tuple(t.shape) for t in outs)))
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if not func.is_view and func not in _NO_BYTES:
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages or key in self._arg_ids:
            return
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def census(self) -> dict:
        """The JAX package's collective census: per kind ``count`` and
        ``bytes`` (result bytes on one rank), and ``total_bytes``.  That
        package weights a loop body's collectives by its trip count and keeps
        the unweighted sum as ``raw_body_once_bytes``; the port's eager step
        runs every layer and so makes every collective it counts, and the
        two sums are equal."""
        census: dict = {}
        for kind, n, _ in self.collectives:
            entry = census.setdefault(kind, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += n
        total = sum(v["bytes"] for v in census.values())
        census["total_bytes"] = total
        census["raw_body_once_bytes"] = total
        return census
