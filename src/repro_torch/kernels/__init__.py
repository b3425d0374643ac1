"""Hand-written Hopper kernels for the compute hot spots.

Each kernel package mirrors the JAX package's trio:
  * ``<name>.py`` — the wrapper of a CUDA C++ kernel in ``csrc/<name>.cu``
    (built by ``_build.py``); it checks its inputs, launches on PyTorch's
    current stream, raises on a launch error, and counts its launches in
    ``<name>.launches``;
  * ``ops.py``    — the public op, dispatching on the tensor's device: the
    plain version for a CPU tensor, the kernel for a CUDA tensor;
  * ``ref.py``    — the plain PyTorch version the kernel is held against.

Kernels:
  * ``rmsnorm``         — fused RMSNorm (bandwidth-bound).
  * ``flash_attention`` — blocked GQA attention forward with causal,
    sliding-window and valid-key masks.
"""

from . import flash_attention, rmsnorm  # noqa: F401
