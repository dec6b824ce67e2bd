"""SparseP SpMV kernels for Hopper (CUDA C++), their plain versions and
the torch oracles.

Modules:
  ref.py         plain torch oracles (the impl="torch" path)
  coo_spmv.py    chunk planner + windowed COO kernel wrapper (csrc/coo_spmv.cu)
  csr_spmv.py    row-granular planner over the windowed kernel
  bcsr_spmv.py   block kernel wrapper for BCOO/BCSR (csrc/bcoo_spmv.cu)
  ell_spmv.py    ELL packing + padded-row kernel wrapper (csrc/ell_spmv.cu)
  ops.py         format dispatch (impl="torch" | "cuda"), kernel_program
  instrument.py  launch counters
  _build.py      nvcc build + ctypes binding of csrc/
"""
from . import ref  # noqa: F401
from .ops import ell_spmv, kernel_program, spmm, spmv  # noqa: F401
