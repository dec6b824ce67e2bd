"""Data partitioning techniques of SparseP (paper §3.2-3.3, Figs. 5-8).

Counterpart of ``repro/core/partition.py``, array for array:

* **1D** — horizontal partitioning across P parts, the whole x per part.
  Balances (paper Table 1): ``rows``, ``nnz-rgrn`` (nnz at row / block-row
  granularity) and ``nnz`` (element / block granularity, COO and BCOO
  only; a row may split between neighbouring parts).
* **2D** — an R x C grid of tiles, one per part, each reading only its
  slice of x; partial outputs are merged afterwards.  Schemes
  ``equally-sized``, ``equally-wide`` and ``variable-sized``.

Every part is stored at a common capacity (the largest part's nonzeros or
blocks) with explicit per-part counts and zero padding, so the parts stack
on a leading part axis: the layout one part-axis kernel launch reads.

The JAX package partitions a dense matrix.  Here the partitioners take the
coalesced, row-sorted triplets a :class:`~repro_torch.api.SparseMatrix`
already holds (``partition_1d_coalesced`` / ``partition_2d_coalesced``), so
a matrix of 2M x 2M is never densified; ``partition_1d`` /
``partition_2d`` keep the JAX signature (a dense matrix) as a front door and
give the same arrays.  Index arithmetic runs on host numpy, values stay
torch tensors (bfloat16 included).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import formats as F

__all__ = [
    "PartitionedMatrix",
    "partition_1d",
    "partition_2d",
    "partition_1d_coalesced",
    "partition_2d_coalesced",
    "BALANCE_1D",
    "SCHEMES_2D",
]

BALANCE_1D = ("rows", "nnz-rgrn", "nnz")  # paper Table 1 (CSR/COO naming)
SCHEMES_2D = ("equally-sized", "equally-wide", "variable-sized")


@dataclass(frozen=True)
class PartitionedMatrix:
    """A sparse matrix partitioned over P = R*C parts, stacked on axis 0.

    Local coordinates: ``rowind`` / ``colind`` are relative to each part's
    (row_start, col_start).  Entries beyond ``nnz[p]`` are padding (values
    zero, indices zero).  Block formats keep values (P, cap, r, c) and
    indices in block units.
    """

    rowind: torch.Tensor  # (P, cap) int32, local
    colind: torch.Tensor  # (P, cap) int32, local
    values: torch.Tensor  # (P, cap) | (P, cap, r, c) for block formats
    nnz: torch.Tensor  # (P,) int32 — nonzeros (or nonzero blocks) per part
    row_start: torch.Tensor  # (P,) int32 — global row offset (element units)
    col_start: torch.Tensor  # (P,) int32 — global col offset (element units)
    row_extent: torch.Tensor  # (P,) int32 — tile height (element units)
    col_extent: torch.Tensor  # (P,) int32 — tile width (element units)
    shape: Tuple[int, int]  # global matrix shape
    grid: Tuple[int, int]  # (R, C) part grid; 1D => (P, 1)
    fmt: str  # 'csr' | 'coo' | 'bcsr' | 'bcoo' — which local kernel runs
    scheme: str  # partitioning/balancing scheme name
    block: Tuple[int, int]  # (1, 1) for scalar formats
    h_pad: int  # padded tile height (max over parts, element units)
    w_pad: int  # padded tile width (element units)

    _tensors = ("rowind", "colind", "values", "nnz", "row_start", "col_start",
                "row_extent", "col_extent")

    @property
    def n_parts(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    @property
    def padding_efficiency(self) -> float:
        """Useful fraction of the stored nnz payload (paper Obs. 10/14)."""
        total = float(self.nnz.sum())
        return total / float(self.n_parts * self.capacity)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def to(self, device) -> "PartitionedMatrix":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._tensors})


# ---------------------------------------------------------------------------
# balancing primitives (host side; the JAX package's, verbatim)
# ---------------------------------------------------------------------------


def _split_rows_equal(rows: int, parts: int) -> np.ndarray:
    """Equal row ranges: boundaries (parts+1,). CSR.row / COO.row scheme."""
    return np.linspace(0, rows, parts + 1).round().astype(np.int64)


def _split_rows_by_nnz(row_nnz: np.ndarray, parts: int) -> np.ndarray:
    """Row-granular nnz balancing: a greedy prefix split of the cumulative
    nnz curve (CSR.nnz / COO.nnz-rgrn, paper Fig. 6 left)."""
    rows = len(row_nnz)
    cum = np.concatenate([[0], np.cumsum(row_nnz, dtype=np.int64)])
    total = cum[-1]
    targets = (np.arange(1, parts, dtype=np.float64) * total / parts)
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [rows]])
    return np.maximum.accumulate(bounds)  # monotone even on empty matrices


def _split_elements(total_nnz: int, parts: int) -> np.ndarray:
    """Element-granular (perfect) nnz split: COO.nnz scheme (rows may split)."""
    return np.linspace(0, total_nnz, parts + 1).round().astype(np.int64)


def _pad_stack(chunks, cap: int) -> torch.Tensor:
    """Stack variable-length chunks into (P, cap, ...), zero-padded."""
    first = chunks[0]
    out = torch.zeros((len(chunks), cap) + tuple(first.shape[1:]),
                      dtype=first.dtype)
    for p, ch in enumerate(chunks):
        out[p, : len(ch)] = ch
    return out


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


# ---------------------------------------------------------------------------
# sorted units: scalar nonzeros or nonzero blocks
# ---------------------------------------------------------------------------


def _units(rowind, colind, values, shape, fmt: str, block):
    """(rowind, colind) as int64 numpy and values as a tensor, sorted by
    (row, col): scalar nonzeros, or for block formats the nonzero blocks
    (values (nb, r, c), indices in block units) — plus the unit grid and
    block size."""
    rows, cols = shape
    if fmt in ("csr", "coo"):
        return (F.to_tensor(rowind).to(torch.int64).numpy(),
                F.to_tensor(colind).to(torch.int64).numpy(),
                F.to_tensor(values), rows, cols, (1, 1))
    if fmt in ("bcsr", "bcoo"):
        bri, bci, tiles = F._blockize(F.to_tensor(rowind).to(torch.int64),
                                      F.to_tensor(colind).to(torch.int64),
                                      F.to_tensor(values), shape, tuple(block))
        return (bri.to(torch.int64).numpy(), bci.to(torch.int64).numpy(), tiles,
                rows // block[0], cols // block[1], tuple(block))
    raise ValueError(f"unknown fmt {fmt!r}")


# ---------------------------------------------------------------------------
# 1D partitioning (paper §3.3.1, Figs. 6-7)
# ---------------------------------------------------------------------------


def partition_1d_coalesced(rowind, colind, values, shape, parts: int,
                           fmt: str = "coo", balance: str = "nnz",
                           block: Tuple[int, int] = (8, 128)
                           ) -> PartitionedMatrix:
    """1D (horizontal) partitioning of coalesced triplets across ``parts``.

    ``rowind`` / ``colind`` / ``values`` are sorted by (row, col), free of
    duplicates and zeros (``formats.coalesce``).

    balance:
      * ``rows``      — equal rows per part (CSR.row / COO.row)
      * ``nnz-rgrn``  — nnz balanced at row granularity (block-row for the
                        block formats)
      * ``nnz``       — perfect element / block balance (COO.nnz / BCOO);
                        rows may split across parts, and the distributed
                        SpMV merges one boundary row per neighbour pair.

    Raises:
      ValueError: unknown fmt or balance; ``nnz`` balance on CSR / BCSR
        (row-sorted formats balance only at row granularity, paper Obs. 7).
    """
    rows, cols = shape
    ri, ci, vals, unit_rows, _, blk = _units(rowind, colind, values, shape,
                                             fmt, block)
    r_blk = blk[0]
    nnz_total = len(ri)

    if balance == "rows":
        bounds = _split_rows_equal(unit_rows, parts)
        cuts = np.searchsorted(ri, bounds)
    elif balance == "nnz-rgrn":
        row_nnz = np.bincount(ri, minlength=unit_rows)
        bounds = _split_rows_by_nnz(row_nnz, parts)
        cuts = np.searchsorted(ri, bounds)
    elif balance == "nnz":
        if fmt in ("csr", "bcsr"):
            raise ValueError(f"{fmt} supports only row-granular balancing")
        cuts = _split_elements(nnz_total, parts)
        bounds = None
    else:
        raise ValueError(f"unknown balance {balance!r}")

    chunks_r, chunks_c, chunks_v = [], [], []
    row_start = np.zeros(parts, np.int64)
    row_extent = np.zeros(parts, np.int64)
    nnz = np.zeros(parts, np.int64)
    for p in range(parts):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        nnz[p] = hi - lo
        if balance == "nnz":
            # the part's row range is the rows it touches (split at edges)
            r0 = int(ri[lo]) if hi > lo else (int(ri[lo - 1]) if lo > 0 else 0)
            r1 = int(ri[hi - 1]) + 1 if hi > lo else r0 + 1
        else:
            r0, r1 = int(bounds[p]), int(bounds[p + 1])
            if r1 == r0:
                r1 = r0 + 1  # keep extents nonzero
        row_start[p] = r0
        row_extent[p] = r1 - r0
        chunks_r.append(_i32(ri[lo:hi] - r0))
        chunks_c.append(_i32(ci[lo:hi]))
        chunks_v.append(vals[lo:hi])
    cap = max(1, int(nnz.max()))

    return PartitionedMatrix(
        rowind=_pad_stack(chunks_r, cap),
        colind=_pad_stack(chunks_c, cap),
        values=_pad_stack(chunks_v, cap),
        nnz=_i32(nnz),
        row_start=_i32(row_start * r_blk),
        col_start=torch.zeros(parts, dtype=torch.int32),
        row_extent=_i32(row_extent * r_blk),
        col_extent=torch.full((parts,), cols, dtype=torch.int32),
        shape=(rows, cols),
        grid=(parts, 1),
        fmt=fmt,
        scheme=f"1d.{balance}",
        block=tuple(block) if fmt in ("bcsr", "bcoo") else (1, 1),
        h_pad=int(row_extent.max()) * r_blk,
        w_pad=cols,
    )


def partition_1d(a, parts: int, fmt: str = "coo", balance: str = "nnz",
                 block: Tuple[int, int] = (8, 128)) -> PartitionedMatrix:
    """1D partitioning of a dense matrix (the JAX signature); the same
    arrays as :func:`partition_1d_coalesced` of its nonzeros."""
    ri, ci, vals, shape = F.nonzero(a)
    return partition_1d_coalesced(ri, ci, vals, shape, parts, fmt, balance,
                                  block)


# ---------------------------------------------------------------------------
# 2D partitioning (paper §3.3.2, Fig. 8)
# ---------------------------------------------------------------------------


def partition_2d_coalesced(rowind, colind, values, shape,
                           grid: Tuple[int, int], fmt: str = "coo",
                           scheme: str = "equally-sized",
                           block: Tuple[int, int] = (8, 128)
                           ) -> PartitionedMatrix:
    """2D tiling of coalesced triplets into an R x C grid, one tile per part.

    * equally-sized  : equal tile heights and widths (paper Fig. 8a)
    * equally-wide   : equal widths; heights balance nnz within each
                       vertical partition (row granularity for CSR,
                       block-row for BCSR, element-exact for COO/BCOO)
                       (Fig. 8b)
    * variable-sized : nnz-balanced widths (column granularity), then
                       nnz-balanced heights within each (Fig. 8c)

    Part ``p = r * C + c`` is tile (r, c).

    Raises:
      ValueError: unknown scheme or fmt.
    """
    if scheme not in SCHEMES_2D:
        raise ValueError(f"unknown 2D scheme {scheme!r}")
    R, C = grid
    rows, cols = shape
    ri_all, ci_all, vals_all, unit_rows, unit_cols, blk = _units(
        rowind, colind, values, shape, fmt, block)
    r_blk, c_blk = blk

    if scheme == "variable-sized":
        col_nnz = np.bincount(ci_all, minlength=unit_cols)
        col_bounds = _split_rows_by_nnz(col_nnz, C)
    else:
        col_bounds = _split_rows_equal(unit_cols, C)

    row_granular = fmt in ("csr", "bcsr")  # paper: CSR balances by rows
    P = R * C
    chunks_r, chunks_c, chunks_v = [None] * P, [None] * P, [None] * P
    nnz = np.zeros(P, np.int64)
    row_start = np.zeros(P, np.int64)
    col_start = np.zeros(P, np.int64)
    row_extent = np.zeros(P, np.int64)
    col_extent = np.zeros(P, np.int64)

    for c in range(C):
        c0, c1 = int(col_bounds[c]), int(col_bounds[c + 1])
        c1 = max(c1, c0 + 1) if unit_cols else c1
        sel = (ci_all >= c0) & (ci_all < c1)
        ri, ci = ri_all[sel], ci_all[sel]  # still row-sorted
        vals = vals_all[torch.from_numpy(sel)]

        if scheme == "equally-sized":
            rbounds = _split_rows_equal(unit_rows, R)
            cuts = np.searchsorted(ri, rbounds)
        elif row_granular:
            row_nnz = np.bincount(ri, minlength=unit_rows)
            rbounds = _split_rows_by_nnz(row_nnz, R)
            cuts = np.searchsorted(ri, rbounds)
        else:
            cuts = _split_elements(len(ri), R)
            rbounds = None

        for r in range(R):
            p = r * C + c  # row-major part id == mesh (rows, cols) layout
            lo, hi = int(cuts[r]), int(cuts[r + 1])
            nnz[p] = hi - lo
            if rbounds is not None:
                r0, r1 = int(rbounds[r]), int(rbounds[r + 1])
                if r1 == r0:
                    r1 = min(r0 + 1, unit_rows) or 1
            else:  # element-granular: the touched row range
                r0 = int(ri[lo]) if hi > lo else 0
                r1 = int(ri[hi - 1]) + 1 if hi > lo else r0 + 1
            row_start[p], col_start[p] = r0, c0
            row_extent[p], col_extent[p] = r1 - r0, c1 - c0
            chunks_r[p] = _i32(ri[lo:hi] - r0)
            chunks_c[p] = _i32(ci[lo:hi] - c0)
            chunks_v[p] = vals[lo:hi]

    cap = max(1, int(nnz.max()))
    return PartitionedMatrix(
        rowind=_pad_stack(chunks_r, cap),
        colind=_pad_stack(chunks_c, cap),
        values=_pad_stack(chunks_v, cap),
        nnz=_i32(nnz),
        row_start=_i32(row_start * r_blk),
        col_start=_i32(col_start * c_blk),
        row_extent=_i32(row_extent * r_blk),
        col_extent=_i32(col_extent * c_blk),
        shape=(rows, cols),
        grid=tuple(grid),
        fmt=fmt,
        scheme=f"2d.{scheme}",
        block=tuple(block) if fmt in ("bcsr", "bcoo") else (1, 1),
        h_pad=int(row_extent.max()) * r_blk,
        w_pad=int(col_extent.max()) * c_blk,
    )


def partition_2d(a, grid: Tuple[int, int], fmt: str = "coo",
                 scheme: str = "equally-sized",
                 block: Tuple[int, int] = (8, 128)) -> PartitionedMatrix:
    """2D tiling of a dense matrix (the JAX signature); the same arrays as
    :func:`partition_2d_coalesced` of its nonzeros."""
    ri, ci, vals, shape = F.nonzero(a)
    return partition_2d_coalesced(ri, ci, vals, shape, grid, fmt, scheme, block)
