"""PyTorch/CUDA port of the FAT int8 serving system (``repro``).

The JAX package ``repro`` is the reference; this package serves the same
models on an NVIDIA H100 through hand-written Hopper kernels
(``repro_torch/csrc``), and on the CPU through their plain PyTorch
versions.  It imports neither JAX nor anything of ``repro``.
"""
