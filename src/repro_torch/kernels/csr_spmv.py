"""CSR path: row-granular chunking of the windowed COO kernel.

Counterpart of ``repro/kernels/csr_spmv.py``.  CSR differs from COO not in
the inner multiply loop but in balancing granularity (paper Obs. 7/16): it
shares the windowed kernel (kernels/coo_spmv.py, ``csrc/coo_spmv.cu``) and
differs only in the host-side chunk planner, which keeps rows whole.  A row
longer than one chunk still splits (paper Obs. 4).
"""
from __future__ import annotations

import numpy as np
import torch

from .coo_spmv import CHUNK_E, ROW_SPAN, ChunkPlan, coo_spmv, plan_chunks

__all__ = ["csr_plan_chunks", "csr_spmv"]


def _expand_rowptr(rowptr: np.ndarray) -> np.ndarray:
    """rowptr (rows+1,) -> per-element row indices (nnz,)."""
    counts = np.diff(np.asarray(rowptr, np.int64))
    return np.repeat(np.arange(len(counts), dtype=np.int64), counts)


def csr_plan_chunks(rowptr, colind, values, out_rows: int | None = None,
                    chunk: int = CHUNK_E, span: int = ROW_SPAN) -> ChunkPlan:
    """Plan row-granular chunks from CSR arrays (host side)."""
    rowptr = np.asarray(rowptr)
    nnz = int(rowptr[-1])
    out_rows = out_rows if out_rows is not None else len(rowptr) - 1
    return plan_chunks(_expand_rowptr(rowptr), np.asarray(colind)[:nnz],
                       values[:nnz], out_rows, chunk=chunk, span=span,
                       row_granular=True)


def csr_spmv(plan: ChunkPlan, x: torch.Tensor,
             batch_tile: int | None = None) -> torch.Tensor:
    """CSR SpMV/SpMM — the windowed kernel on a row-granular chunk plan."""
    return coo_spmv(plan, x, batch_tile)
