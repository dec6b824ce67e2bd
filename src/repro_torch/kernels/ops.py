"""SpMV/SpMM entry points and format dispatch.

Counterpart of ``repro/kernels/ops.py``.  Two implementations per format:

  * ``impl="torch"`` — the plain oracles of kernels/ref.py (the JAX
    package's ``impl="xla"``); any device.
  * ``impl="cuda"``  — the hand-written CUDA kernels (the JAX package's
    ``impl="pallas"``).  On a CPU device each kernel's plain version runs
    over the same host plan, as ``interpret=True`` did for Pallas.

:func:`kernel_program` builds the host plan once and places it on the
device once; the callable it returns runs only the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core import formats as F
from . import ref
from .bcsr_spmv import bcoo_spmv, bcoo_spmv_plain, block_row_ptr
from .coo_spmv import ChunkPlan, coo_spmv, coo_spmv_plain, plan_chunks
from .csr_spmv import csr_plan_chunks
from .ell_spmv import ell_spmv

__all__ = ["spmv", "spmm", "kernel_program", "KernelProgram", "IMPLS",
           "ell_spmv"]

IMPLS = ("torch", "cuda")


def spmv(m, x: torch.Tensor, impl: str = "torch") -> torch.Tensor:
    """y = m @ x for any container format (single device).

    ``impl="torch"`` runs the oracle on the container's tensors (which must
    lie on x's device) and returns the values dtype; ``impl="cuda"`` builds
    a :func:`kernel_program` on x's device and returns the accumulation
    dtype.
    """
    if impl == "torch":
        if isinstance(m, F.CSR):
            return ref.csr_spmv_ref(m.rowptr, m.colind, m.values, x, m.rows)
        if isinstance(m, F.COO):
            return ref.coo_spmv_ref(m.rowind, m.colind, m.values, x, m.rows,
                                    m.nnz)
        if isinstance(m, F.BCSR):
            return ref.bcsr_spmv_ref(m.browptr, m.bcolind, m.bvalues, x, m.rows)
        if isinstance(m, F.BCOO):
            return ref.bcoo_spmv_ref(m.browind, m.bcolind, m.bvalues, x, m.rows,
                                     m.nblocks)
        raise TypeError(type(m))
    if impl == "cuda":
        return kernel_program(m, device=x.device)(x)
    raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")


@dataclass(frozen=True)
class KernelProgram:
    """One container's kernel program, its arrays placed on ``device``.

    ``prog(x)`` runs the kernel (on a CPU device: its plain version);
    ``prog.plain(x)`` runs the plain version on the same placed arrays.
    """

    kind: str  # "coo" (COO and CSR plans) | "bcoo" (BCOO and BCSR)
    device: torch.device
    batch_tile: Optional[int] = None
    plan: Optional[ChunkPlan] = None  # coo
    browind: Optional[torch.Tensor] = None  # bcoo ...
    bcolind: Optional[torch.Tensor] = None
    bvalues: Optional[torch.Tensor] = None
    browptr: Optional[torch.Tensor] = None
    rows: int = 0
    nblocks: int = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device)
        if self.kind == "coo":
            return coo_spmv(self.plan, x, self.batch_tile)
        return bcoo_spmv(self.browind, self.bcolind, self.bvalues, x, self.rows,
                         self.nblocks, self.batch_tile, browptr=self.browptr)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device)
        if self.kind == "coo":
            return coo_spmv_plain(self.plan, x)
        return bcoo_spmv_plain(self.browind, self.bcolind, self.bvalues, x,
                               self.rows, self.nblocks)


def kernel_program(m, batch_tile: int | None = None, device=None) -> KernelProgram:
    """Build the kernel SpMV/SpMM program for a container (plan once).

    The host-side preprocessing (chunk planning and the CUDA kernel's piece
    table for COO/CSR, the block-row pointer for BCOO) runs exactly once here, and its arrays are placed on
    ``device`` (default: the container's) once; the returned program takes
    x of shape (cols,) or (cols, B), moves it to that device if needed, and
    runs only the kernel — or, on a CPU device, its plain version.

    Returns:
      A :class:`KernelProgram`; ``prog(x)`` is y in the kernel accumulation
      dtype, on ``device``.

    Raises:
      TypeError: for an unknown container type.
    """
    device = torch.device(device) if device is not None else m.device
    host = m.to("cpu")
    if isinstance(host, F.CSR):
        plan = csr_plan_chunks(host.rowptr, host.colind, host.values, host.rows)
        return KernelProgram("coo", device, batch_tile, plan=plan.to(device))
    if isinstance(host, F.COO):
        nnz = host.nnz
        plan = plan_chunks(host.rowind[:nnz], host.colind[:nnz],
                           host.values[:nnz], host.rows)
        return KernelProgram("coo", device, batch_tile, plan=plan.to(device))
    if isinstance(host, (F.BCSR, F.BCOO)):
        dev = m.to(device)
        if isinstance(dev, F.BCSR):
            browptr, browind = dev.browptr, _bcsr_to_bcoo_indices(dev)
        else:
            browind = dev.browind
            browptr = block_row_ptr(browind, dev.nblocks, dev.block_rows)
        return KernelProgram("bcoo", device, batch_tile, browind=browind,
                             bcolind=dev.bcolind, bvalues=dev.bvalues,
                             browptr=browptr, rows=dev.rows, nblocks=dev.nblocks)
    raise TypeError(type(m))


def spmm(m, X: torch.Tensor, impl: str = "torch") -> torch.Tensor:
    """Multi-RHS SpMV: Y = m @ X with X of shape (cols, B) -> (rows, B).

    Raises:
      ValueError: if X is not 2D, or the impl is unknown.
    """
    if X.ndim != 2:
        raise ValueError(f"spmm expects X of shape (cols, B); got {tuple(X.shape)}")
    return spmv(m, X, impl=impl)


def _bcsr_to_bcoo_indices(m: F.BCSR) -> torch.Tensor:
    k = torch.arange(m.bcapacity, dtype=torch.int32, device=m.device)
    browind = torch.searchsorted(m.browptr, k, right=True).to(torch.int32) - 1
    return browind.clamp(0, m.block_rows - 1)
