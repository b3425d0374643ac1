"""PyTorch/CUDA port of ``repro`` (the JAX package), for NVIDIA Hopper.

The port keeps the JAX package's module names so each module has an obvious
counterpart, imports nothing of it (nor of JAX), and builds its CUDA kernels
only at first use, so importing it never compiles anything.
"""
