"""Hand-written Hopper kernels for the compute hot spots.

Each kernel package mirrors the JAX package's trio:
  * ``<name>.py`` — the wrappers of CUDA C++ kernels in ``csrc/`` (built by
    ``_build.py``); each checks its inputs, launches on PyTorch's current
    stream, raises on a launch error, and counts its calls in
    ``<wrapper>.launches``;
  * ``ops.py``    — the public op, dispatching on the tensor's device: the
    plain version for a CPU tensor, the kernels for a CUDA tensor (forward
    and, through a ``torch.autograd.Function``, backward);
  * ``ref.py``    — the plain PyTorch version the kernels are held against.

Kernels:
  * ``gc_coding``       — the coded combine of gradient coding, weights @ parts
    (bandwidth-bound): GC encode and survivor-weighted decode.
  * ``rmsnorm``         — fused RMSNorm forward and backward (bandwidth-bound).
  * ``flash_attention`` — blocked GQA attention forward and backward with
    causal, sliding-window and valid-key masks.
  * ``gate_window``     — the wait-out gate's per-cell window statistics
    (integer-only, launch-bound at the gate's sizes): ``window_stats`` for the
    all-or-nothing admission, ``buffer_stats`` for the selective one.
  * ``ssd_scan``        — Mamba2's SSD intra-chunk block (scores C.B^T, the
    causal decay mask and the product with x*dt, per batch-chunk; bound by
    bytes), forward only; and the fused chunk scan (the chunk's whole
    output), forward and backward.
"""

from . import flash_attention, gate_window, gc_coding, rmsnorm, ssd_scan  # noqa: F401
