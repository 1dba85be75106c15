"""PyTorch + CUDA port of cinema_tpu for one NVIDIA H100.

The JAX package ``cinema_tpu`` stays the reference; this package imports
neither jax nor anything of it. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package on a ported path is a hand-written CUDA kernel
under ``csrc/``, built with nvcc on first use (see ``build.py``), with a
plain PyTorch version of the same math beside it. Entry points run on
``device="cuda"`` unless the caller asks for the CPU.
"""
