"""repro_torch — SparseP's SpMV pipeline in PyTorch, with hand-written CUDA
kernels for Hopper (H100).

The port of the JAX package ``repro``, module for module (``core/``,
``kernels/``, ``api/``).  It imports torch, numpy and the standard library
only.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
