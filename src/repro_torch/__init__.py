"""ULISSE on PyTorch and CUDA: the port of the `repro` JAX package.

Imports torch and numpy only (never jax, never `repro`).  Entry points
run on CUDA unless the caller passes device="cpu"; the CUDA kernels
(`repro_torch.kernels`) are built on first use.  See README.md.
"""
