"""Matrix statistics and sparsity-pattern classification (numpy).

Counterpart of ``repro/core/stats.py``, kept as a copy so that this package
never imports the JAX one.  Reproduces the metrics of paper Tables 3/4/8:
sparsity, NNZ-r-std (standard deviation of nonzeros per row), NNZ-c-std
(per column), plus the paper's classification rule: matrices with
NNZ-r-std > 25 are *scale-free*, the rest *regular*; matrices whose
nonzeros mostly fall in dense sub-blocks are *block-pattern*.

These statistics drive the adaptive scheme selection (core/adaptive.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MatrixStats", "compute_stats", "SCALE_FREE_ROW_STD"]

# Paper §4: "matrices in which NNZ-r-std is larger than 25 ... scale-free".
SCALE_FREE_ROW_STD = 25.0


@dataclass(frozen=True)
class MatrixStats:
    rows: int
    cols: int
    nnz: int
    sparsity: float  # nnz / (rows * cols)
    nnz_r_std: float  # std of nonzeros per row
    nnz_c_std: float  # std of nonzeros per column
    nnz_r_max: int  # densest row (drives CSR.nnz imbalance, Obs. 4)
    block_fill: float  # fraction of touched r x c blocks' slots that are nonzero
    is_scale_free: bool
    is_block_pattern: bool

    @property
    def is_regular(self) -> bool:
        return not self.is_scale_free


def compute_stats(
    a_or_coo,
    block: tuple[int, int] = (8, 128),
    block_pattern_threshold: float = 0.5,
) -> MatrixStats:
    """Compute paper Table-4 statistics from a dense array or (rowind, colind, shape).

    A dense input may be a numpy array or a torch tensor; only its nonzero
    pattern is read.  ``block_fill`` is the mean occupancy of *nonempty*
    blocks: block-pattern matrices have block_fill near 1, scale-free web
    graphs near 1/(r*c).
    """
    if isinstance(a_or_coo, tuple):
        rowind, colind, shape = a_or_coo
        rowind = np.asarray(rowind)
        colind = np.asarray(colind)
        rows, cols = shape
    else:
        rows, cols = a_or_coo.shape
        if isinstance(a_or_coo, np.ndarray):
            rowind, colind = np.nonzero(a_or_coo)
        else:  # torch tensor (any dtype, bfloat16 included)
            rowind, colind = (t.numpy() for t in (a_or_coo != 0).nonzero(as_tuple=True))
    nnz = int(len(rowind))

    r_counts = np.bincount(rowind, minlength=rows) if nnz else np.zeros(rows)
    c_counts = np.bincount(colind, minlength=cols) if nnz else np.zeros(cols)
    nnz_r_std = float(np.std(r_counts)) if rows else 0.0
    nnz_c_std = float(np.std(c_counts)) if cols else 0.0

    r, c = block
    if nnz:
        bids = (rowind // r).astype(np.int64) * ((cols + c - 1) // c) + colind // c
        _, per_block = np.unique(bids, return_counts=True)
        block_fill = float(per_block.mean() / (r * c))
    else:
        block_fill = 0.0

    sparsity = nnz / float(rows * cols) if rows and cols else 0.0
    return MatrixStats(
        rows=rows,
        cols=cols,
        nnz=nnz,
        sparsity=sparsity,
        nnz_r_std=nnz_r_std,
        nnz_c_std=nnz_c_std,
        nnz_r_max=int(r_counts.max()) if nnz else 0,
        block_fill=block_fill,
        is_scale_free=nnz_r_std > SCALE_FREE_ROW_STD,
        is_block_pattern=block_fill >= block_pattern_threshold,
    )
