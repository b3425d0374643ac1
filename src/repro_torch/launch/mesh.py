"""Production meshes as ``torch.distributed`` DeviceMeshes.  Port of
``src/repro/launch/mesh.py``.

The production meshes are 256 ranks (16 x 16) for one pod and 512 (2 x 16 x
16) for the multi-pod dry-run.  Axes: "data" carries the gradient-coding
worker axis (batch and coded chunks), "model" tensor parallelism, and "pod"
the outer data-parallel axis across pods.

The dry-run builds them over a *rank-only* group (``rank_only_group``): a
default process group of 256 or 512 ranks of which this process is rank 0 and
whose peers do not exist.  Its collectives return at once with outputs of the
right shapes, so a step on meta DTensors traces with real shapes, allocates
nothing and sends nothing.  ``make_local_mesh`` builds a mesh over real ranks
(one process each, its default group opened by ``local_group`` or the caller).

Nothing here opens a group or touches a device at import.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.devices import resolve_device

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextlib.contextmanager
def rank_only_group(world_size: int):
    """The rank-only default group of ``world_size`` ranks (module docstring)
    for the block.  Yields True where it opened the group, and closes it after;
    yields False, and leaves the group alone, where the caller already has a
    default group open."""
    if dist.is_initialized():
        yield False
        return
    # torch ships the rank-only backend ("fake") under a private name: this is
    # the one place the port names it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield True
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_group(device="cuda"):
    """A default group of one real rank for the block: NCCL for a CUDA device
    (raises with no card), gloo for the CPU.  More ranks are one process each,
    and each opens its own group (``init_process_group`` with a
    ``tcp://localhost`` address)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, device_type: str = "cpu"):
    """A mesh of ``shape`` over the first ranks of the open default group, its
    axes ("data", "model") or ("pod", "data", "model")."""
    shape = tuple(shape)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {have}: open "
                           f"rank_only_group({n}) (or a real group) first")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=AXES[len(shape)])


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 with "pod", over the rank-only
    group; raises with fewer ranks open, as the JAX package's does with fewer
    devices.  The dry-run's tensors are meta tensors, so the mesh's device type
    is the CPU's."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD)


def make_local_mesh(n_data: int = 1, n_model: int = 1, device="cuda"):
    """(n_data, n_model) mesh over real local ranks, the counterpart of the
    JAX package's ``make_cpu_mesh``: on the card unless ``device="cpu"`` is
    asked for (raises with no card)."""
    dev = resolve_device(device)
    return make_mesh((n_data, n_model), dev.type)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch / GC-worker dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str | None:
    return "model" if "model" in mesh.mesh_dim_names else None
