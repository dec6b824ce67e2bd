"""Compressed sparse matrix formats as frozen dataclasses of torch tensors.

Counterpart of ``repro/core/formats.py``: the four general formats of the
paper (§2.1.1, Fig. 2) — CSR, COO, BCSR, BCOO — with the same capacity and
padding conventions, so that every array equals the JAX package's:

  * index arrays are int32 and may be padded past ``nnz``/``nblocks``
    (value 0, index clamped in range); COO pad rows point at the last row,
    BCOO pad block-rows at the last block-row;
  * entries are row-sorted, then column-sorted;
  * a block is kept when ``abs(tile).sum() != 0``.

Containers are built on the host (CPU tensors) and moved to a device with
``.to(device)``.  Besides ``dense_to_*`` there are triplet builders
(``triplets_to_*``) that give the same arrays without ever allocating the
dense matrix — the only way to build a container for a matrix with millions
of rows.

bfloat16 has no numpy dtype unless ``ml_dtypes`` is installed, so values
travel as torch tensors; :func:`to_tensor` also accepts ml_dtypes bfloat16
arrays (by bit view, without importing ml_dtypes).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "CSR",
    "COO",
    "BCSR",
    "BCOO",
    "dense_to_csr",
    "dense_to_coo",
    "dense_to_bcsr",
    "dense_to_bcoo",
    "triplets_to_csr",
    "triplets_to_coo",
    "triplets_to_bcsr",
    "triplets_to_bcoo",
    "coalesce",
    "nonzero",
    "from_coalesced",
    "to_triplets",
    "csr_to_coo",
    "coo_to_csr",
    "to_dense",
    "to_tensor",
    "torch_dtype",
    "dtype_name",
    "SUPPORTED_DTYPES",
]

# Data types supported by SparseP (paper §3: int8..fp64).  fp64 and int64 are
# kept for host-side oracles; the CUDA kernels take the rest (plus float16).
SUPPORTED_DTYPES = (
    torch.int8,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.bfloat16,
    torch.float32,
    torch.float64,
)

_BY_NAME = {
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(d) -> torch.dtype:
    """Normalise a torch dtype, numpy dtype/type or dtype name to torch."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {d!r}") from None


def dtype_name(d) -> str:
    """numpy-style name of a dtype ("float32", "bfloat16", ...)."""
    return str(torch_dtype(d)).removeprefix("torch.")


def to_tensor(a, dtype=None) -> torch.Tensor:
    """Host array-like -> tensor (no copy where possible; bf16-aware).

    numpy bfloat16 arrays (ml_dtypes) are taken by bit view; tensors pass
    through (on their own device).  ``dtype`` converts afterwards.
    """
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
            a = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
        else:
            a = np.ascontiguousarray(a)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
    if dtype is not None:
        a = a.to(torch_dtype(dtype))
    return a


class _Container:
    """Shared surface: ``.to(device)`` moves every tensor field."""

    _tensors: Tuple[str, ...] = ()

    def to(self, device):
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._tensors})

    @property
    def device(self) -> torch.device:
        return getattr(self, self._tensors[0]).device

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]


@dataclass(frozen=True)
class CSR(_Container):
    """Compressed Sparse Row (paper Fig. 2b).

    rowptr[i:i+2] brackets the slice of colind/values for row i.
    Arrays may be padded beyond ``nnz`` (colind clamped, values zero).
    """

    rowptr: torch.Tensor  # (rows + 1,) int32
    colind: torch.Tensor  # (capacity,)  int32
    values: torch.Tensor  # (capacity,)  dtype
    shape: Tuple[int, int]  # (rows, cols)
    _tensors = ("rowptr", "colind", "values")

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


@dataclass(frozen=True)
class COO(_Container):
    """Coordinate format (paper Fig. 2c): row-sorted (row, col, value) tuples,
    stored struct-of-arrays.  Row-sortedness is relied on by the windowed
    kernel's chunk planner."""

    rowind: torch.Tensor  # (capacity,) int32
    colind: torch.Tensor  # (capacity,) int32
    values: torch.Tensor  # (capacity,) dtype
    shape: Tuple[int, int]
    nnz: int = None  # actual nonzeros (<= capacity)
    _tensors = ("rowind", "colind", "values")

    def __post_init__(self):
        if self.nnz is None:
            object.__setattr__(self, "nnz", self.values.shape[0])

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


@dataclass(frozen=True)
class BCSR(_Container):
    """Block Compressed Sparse Row (paper Fig. 2d): nonzero r x c sub-blocks
    stored densely; browptr indexes block rows."""

    browptr: torch.Tensor  # (block_rows + 1,) int32
    bcolind: torch.Tensor  # (bcapacity,)      int32 — block-column index
    bvalues: torch.Tensor  # (bcapacity, r, c) dtype — dense sub-blocks
    shape: Tuple[int, int]  # (rows, cols) — multiples of (r, c)
    block: Tuple[int, int]  # (r, c)
    _tensors = ("browptr", "bcolind", "bvalues")

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.block[0]

    @property
    def block_cols(self) -> int:
        return self.shape[1] // self.block[1]

    @property
    def nblocks(self) -> int:
        return int(self.browptr[-1])

    @property
    def bcapacity(self) -> int:
        return self.bvalues.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.bvalues.dtype


@dataclass(frozen=True)
class BCOO(_Container):
    """Block Coordinate format (paper Fig. 2e): block-row-sorted block tuples."""

    browind: torch.Tensor  # (bcapacity,) int32
    bcolind: torch.Tensor  # (bcapacity,) int32
    bvalues: torch.Tensor  # (bcapacity, r, c) dtype
    shape: Tuple[int, int]
    block: Tuple[int, int]
    nblocks: int = None
    _tensors = ("browind", "bcolind", "bvalues")

    def __post_init__(self):
        if self.nblocks is None:
            object.__setattr__(self, "nblocks", self.bvalues.shape[0])

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.block[0]

    @property
    def block_cols(self) -> int:
        return self.shape[1] // self.block[1]

    @property
    def bcapacity(self) -> int:
        return self.bvalues.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.bvalues.dtype


# ---------------------------------------------------------------------------
# Host-side constructors.  Every builder goes through sorted, duplicate-free,
# zero-free triplets; dense_to_* only derives them from the dense matrix.
# ---------------------------------------------------------------------------


def _pad_to(t: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    if t.shape[0] >= capacity:
        return t[:capacity]
    pad = torch.full((capacity - t.shape[0],) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype)
    return torch.cat([t, pad])


def coalesce(rowind, colind, values, shape):
    """Sort triplets by (row, col), sum duplicates, drop entries equal to 0.

    Duplicates are summed in the values' dtype in their input order (as
    ``np.add.at`` into a zero matrix does).  Returns int64 ``rowind``,
    ``colind`` and the summed values, all CPU tensors.
    """
    rows, cols = shape
    ri = to_tensor(rowind).to(torch.int64).reshape(-1)
    ci = to_tensor(colind).to(torch.int64).reshape(-1)
    vals = to_tensor(values).reshape(-1)
    key = ri * cols + ci
    key, order = torch.sort(key, stable=True)
    vals = vals[order]
    uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
    if len(uniq) < len(key):
        vals = torch.zeros(len(uniq), dtype=vals.dtype).index_add_(0, inverse, vals)
    keep = vals != 0
    uniq, vals = uniq[keep], vals[keep]
    return uniq // cols, uniq % cols, vals


def nonzero(a):
    """(rowind, colind, values, shape) of a dense matrix's nonzeros, row-major."""
    t = to_tensor(a)
    if t.ndim != 2:
        raise ValueError(f"expected a 2D matrix, got shape {tuple(t.shape)}")
    ri, ci = (t != 0).nonzero(as_tuple=True)  # row-major: rows then cols
    return ri, ci, t[ri, ci], tuple(t.shape)


def _capacity(capacity, n):
    capacity = capacity or max(1, n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} below nnz {n}")
    return capacity


def _csr(ri, ci, vals, shape, capacity):
    rows, _ = shape
    rowptr = torch.zeros(rows + 1, dtype=torch.int64)
    rowptr[1:] = torch.bincount(ri, minlength=rows)
    capacity = _capacity(capacity, len(vals))
    return CSR(
        rowptr=torch.cumsum(rowptr, 0).to(torch.int32),
        colind=_pad_to(ci.to(torch.int32), capacity),
        values=_pad_to(vals, capacity),
        shape=tuple(shape),
    )


def _coo(ri, ci, vals, shape, capacity):
    rows, _ = shape
    nnz = len(vals)
    capacity = _capacity(capacity, nnz)
    # Padding rows point at the last row so padded (zero) contributions land
    # harmlessly (they add 0 to a real output slot).
    pad_row = rows - 1 if rows else 0
    return COO(
        rowind=_pad_to(ri.to(torch.int32), capacity, pad_row),
        colind=_pad_to(ci.to(torch.int32), capacity),
        values=_pad_to(vals, capacity),
        shape=tuple(shape),
        nnz=nnz,
    )


def _blockize(ri, ci, vals, shape, block):
    """(browind, bcolind, bvalues) of the kept blocks, block-row sorted."""
    r, c = block
    rows, cols = shape
    if rows % r or cols % c:
        raise ValueError(f"{tuple(shape)} not divisible by {tuple(block)}")
    bc = cols // c
    bid, inv = torch.unique(ri // r * bc + ci // c, sorted=True,
                            return_inverse=True)
    tiles = torch.zeros((len(bid), r, c), dtype=vals.dtype)
    tiles[inv, ri % r, ci % c] = vals
    # The dense builder's rule, abs().sum() != 0, with numpy's sum dtype
    # (integer abs wraps at the type's minimum, sums widen to int64).
    wide = torch.float64 if vals.dtype.is_floating_point else torch.int64
    keep = tiles.abs().to(wide).sum((1, 2)) != 0
    bid, tiles = bid[keep], tiles[keep]
    return (bid // bc).to(torch.int32), (bid % bc).to(torch.int32), tiles


def _bcsr(ri, ci, vals, shape, block, capacity):
    browind, bcolind, bvalues = _blockize(ri, ci, vals, shape, block)
    br = shape[0] // block[0]
    browptr = torch.zeros(br + 1, dtype=torch.int64)
    browptr[1:] = torch.bincount(browind.to(torch.int64), minlength=br)
    capacity = _capacity(capacity, len(bcolind))
    return BCSR(
        browptr=torch.cumsum(browptr, 0).to(torch.int32),
        bcolind=_pad_to(bcolind, capacity),
        bvalues=_pad_to(bvalues, capacity),
        shape=tuple(shape),
        block=tuple(block),
    )


def _bcoo(ri, ci, vals, shape, block, capacity):
    browind, bcolind, bvalues = _blockize(ri, ci, vals, shape, block)
    nb = len(bcolind)
    capacity = _capacity(capacity, nb)
    pad_row = shape[0] // block[0] - 1 if shape[0] else 0
    return BCOO(
        browind=_pad_to(browind, capacity, pad_row),
        bcolind=_pad_to(bcolind, capacity),
        bvalues=_pad_to(bvalues, capacity),
        shape=tuple(shape),
        block=tuple(block),
        nblocks=nb,
    )


def dense_to_csr(a, capacity: int | None = None) -> CSR:
    return _csr(*nonzero(a), capacity)


def dense_to_coo(a, capacity: int | None = None) -> COO:
    return _coo(*nonzero(a), capacity)


def dense_to_bcsr(a, block: Tuple[int, int] = (8, 128),
                  capacity: int | None = None) -> BCSR:
    return _bcsr(*nonzero(a), block, capacity)


def dense_to_bcoo(a, block: Tuple[int, int] = (8, 128),
                  capacity: int | None = None) -> BCOO:
    return _bcoo(*nonzero(a), block, capacity)


def triplets_to_csr(rowind, colind, values, shape,
                    capacity: int | None = None) -> CSR:
    """Same arrays as ``dense_to_csr`` of the matrix the triplets sum to."""
    return _csr(*coalesce(rowind, colind, values, shape), shape, capacity)


def triplets_to_coo(rowind, colind, values, shape,
                    capacity: int | None = None) -> COO:
    """Same arrays as ``dense_to_coo`` of the matrix the triplets sum to."""
    return _coo(*coalesce(rowind, colind, values, shape), shape, capacity)


def triplets_to_bcsr(rowind, colind, values, shape,
                     block: Tuple[int, int] = (8, 128),
                     capacity: int | None = None) -> BCSR:
    """Same arrays as ``dense_to_bcsr`` of the matrix the triplets sum to."""
    return _bcsr(*coalesce(rowind, colind, values, shape), shape, block, capacity)


def triplets_to_bcoo(rowind, colind, values, shape,
                     block: Tuple[int, int] = (8, 128),
                     capacity: int | None = None) -> BCOO:
    """Same arrays as ``dense_to_bcoo`` of the matrix the triplets sum to."""
    return _bcoo(*coalesce(rowind, colind, values, shape), shape, block, capacity)


def from_coalesced(fmt: str, rowind, colind, values, shape,
                   block: Tuple[int, int] = (8, 128),
                   capacity: int | None = None):
    """Build ``fmt`` from triplets that are already sorted by (row, col),
    duplicate-free and zero-free (the output of :func:`coalesce`)."""
    if fmt == "csr":
        return _csr(rowind, colind, values, shape, capacity)
    if fmt == "coo":
        return _coo(rowind, colind, values, shape, capacity)
    if fmt == "bcsr":
        return _bcsr(rowind, colind, values, shape, block, capacity)
    if fmt == "bcoo":
        return _bcoo(rowind, colind, values, shape, block, capacity)
    raise ValueError(f"unknown format {fmt!r}")


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def _expand_ptr(ptr: torch.Tensor, capacity: int, n_rows: int) -> torch.Tensor:
    """Per-slot row index of a rowptr-style array (clamped for padding)."""
    k = torch.arange(capacity, dtype=ptr.dtype, device=ptr.device)
    ind = torch.searchsorted(ptr, k, right=True).to(torch.int32) - 1
    return ind.clamp(0, max(n_rows - 1, 0))


def csr_to_coo(m: CSR) -> COO:
    """Expand rowptr to explicit row indices."""
    return COO(
        rowind=_expand_ptr(m.rowptr, m.capacity, m.rows),
        colind=m.colind,
        values=m.values,
        shape=m.shape,
        nnz=m.nnz,
    )


def coo_to_csr(m: COO) -> CSR:
    """Counting-sort rows to rowptr; requires row-sorted input."""
    rowptr = torch.zeros(m.rows + 1, dtype=torch.int64, device=m.device)
    rowptr[1:] = torch.bincount(m.rowind[: m.nnz].to(torch.int64),
                                minlength=m.rows)
    return CSR(rowptr=torch.cumsum(rowptr, 0).to(torch.int32),
               colind=m.colind, values=m.values, shape=m.shape)


def to_dense(m) -> torch.Tensor:
    """Densify any format (oracle path; used only in tests)."""
    if isinstance(m, CSR):
        m = csr_to_coo(m)
    if isinstance(m, COO):
        n = m.nnz
        out = torch.zeros(m.shape, dtype=m.dtype, device=m.device)
        return out.index_put_((m.rowind[:n].long(), m.colind[:n].long()),
                              m.values[:n], accumulate=True)
    if isinstance(m, (BCSR, BCOO)):
        r, c = m.block
        n = m.nblocks
        browind = (_expand_ptr(m.browptr, m.bcapacity, m.block_rows)
                   if isinstance(m, BCSR) else m.browind)
        out = torch.zeros((m.block_rows, m.block_cols, r, c), dtype=m.dtype,
                          device=m.device)
        out.index_put_((browind[:n].long(), m.bcolind[:n].long()),
                       m.bvalues[:n], accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(m.shape)
    raise TypeError(f"unknown format {type(m)}")


def to_triplets(m):
    """(rowind, colind, values) of a container's stored entries (block
    formats: every slot of every stored block, zeros included)."""
    if isinstance(m, CSR):
        m = csr_to_coo(m)
    if isinstance(m, COO):
        n = m.nnz
        return m.rowind[:n], m.colind[:n], m.values[:n]
    if isinstance(m, (BCSR, BCOO)):
        r, c = m.block
        n = m.nblocks
        browind = (_expand_ptr(m.browptr, m.bcapacity, m.block_rows)
                   if isinstance(m, BCSR) else m.browind)
        i, k = torch.meshgrid(torch.arange(r, device=m.device),
                              torch.arange(c, device=m.device), indexing="ij")
        rows = browind[:n, None, None].long() * r + i
        cols = m.bcolind[:n, None, None].long() * c + k
        return rows.reshape(-1), cols.reshape(-1), m.bvalues[:n].reshape(-1)
    raise TypeError(f"unknown format {type(m)}")
