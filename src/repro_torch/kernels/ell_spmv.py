"""ELL (padded-row) SpMV/SpMM: host packing, plain version and the CUDA
kernel's wrapper.

Counterpart of ``repro/kernels/ell_spmv.py``.  Every row is padded to K
slots: ``colind`` / ``values`` of shape (rows, K) and ``row_nnz`` (rows,),
the real slots per row.  SpMV is a gather of x, a multiply and a row sum
over the real slots, with no merge step at all.  The TPU kernel took a
(64-row, 128-lane) tile per grid step; the Hopper kernel
(``csrc/ell_spmv.cu``, see its header for the design and what bounds it)
copies each tile of rows, one contiguous run of the row-major arrays, into
shared memory with the TMA, double-buffered, and sums every (row, batch
column) over the row's real slots in slot order.

:func:`ell_spmv` dispatches on the device of ``x``: a CPU tensor runs the
plain version :func:`ell_spmv_plain`, a CUDA tensor launches the kernel
(:func:`ell_spmv_cuda`) or raises.
"""
from __future__ import annotations

import torch

from ..core import formats as F
from . import _build
from .instrument import record_launch
from .ref import acc_dtype

__all__ = ["dense_to_ell", "ell_spmv", "ell_spmv_plain", "ell_spmv_cuda",
           "BATCH_TILE"]

BATCH_TILE = 32  # SpMM columns per CTA of the CUDA kernel


def _pack_ell(rowind, colind, values, rows: int, k: int | None = None):
    """Row-sorted triplets (the output of ``formats.coalesce``) ->
    ``(colind, values, row_nnz)``, rows padded to K slots; never densifies.

    K defaults to the densest row (at least 1); with ``k`` given, a row keeps
    its first K nonzeros in column order and ``row_nnz`` is clipped to K.
    """
    ri = F.to_tensor(rowind).to(torch.int64).reshape(-1)
    ci = F.to_tensor(colind).to(torch.int32).reshape(-1)
    vals = F.to_tensor(values).reshape(-1)
    counts = torch.bincount(ri, minlength=rows)
    K = int(k) if k is not None else max(1, int(counts.max()) if len(ri) else 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(len(ri)) - starts[ri]
    keep = pos < K
    ri, pos = ri[keep], pos[keep]
    col_out = torch.zeros((rows, K), dtype=torch.int32)
    val_out = torch.zeros((rows, K), dtype=vals.dtype)
    col_out[ri, pos] = ci[keep]
    val_out[ri, pos] = vals[keep]
    return col_out, val_out, counts.clamp(max=K).to(torch.int32)


def dense_to_ell(a, k: int | None = None):
    """Host-side ELL packing of a dense matrix: ``(colind, values,
    row_nnz)``, rows padded to K — the JAX package's arrays, as tensors."""
    ri, ci, vals, shape = F.nonzero(a)
    return _pack_ell(ri, ci, vals, shape[0], k)


def ell_spmv_plain(colind, values, row_nnz, x) -> torch.Tensor:
    """The kernel's function in plain torch, on any device.

    Slots k >= row_nnz[r] add nothing; columns are clipped to x's rows.
    Returns y (rows[, B]) in the accumulation dtype.
    """
    rows, K = values.shape
    acc = acc_dtype(values.dtype)
    tail = (1,) * (x.ndim - 1)
    xv = x[colind.long().clamp(0, x.shape[0] - 1)].to(acc)  # (rows, K[, B])
    prod = values.to(acc).reshape((rows, K) + tail) * xv
    mask = torch.arange(K, device=values.device)[None, :] < row_nnz[:, None]
    prod = torch.where(mask.reshape((rows, K) + tail), prod,
                       torch.zeros((), dtype=acc, device=prod.device))
    return prod.sum(1, dtype=acc)


def ell_spmv_cuda(colind, values, row_nnz, x,
                  batch_tile: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on ELL arrays and x that lie on one CUDA device.

    One launch covers every batch tile.  Returns y (rows[, B]) in the
    accumulation dtype.

    Raises:
      ValueError/TypeError: wrong device, dtype, shape or contiguity
        (float64 and int64 values included: the kernel does not take them).
      RuntimeError: the launch failed.
    """
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_cuda needs a CUDA tensor; x is on {x.device}")
    B, squeeze = _build.check_x(x, values.dtype, "ell_spmv_cuda")
    _build.check_index(colind, x.device, "colind")
    _build.check_index(row_nnz, x.device, "row_nnz")
    if values.device != x.device or not values.is_contiguous() \
            or values.ndim != 2 or colind.shape != values.shape \
            or row_nnz.shape != values.shape[:1]:
        raise ValueError(f"values must be a contiguous (rows, K) tensor on "
                         f"{x.device}, colind of its shape and row_nnz (rows,)")
    rows, K = values.shape
    bt = min(B, BATCH_TILE if batch_tile is None else batch_tile)
    if not 1 <= bt <= BATCH_TILE:
        raise ValueError(f"batch_tile must be in [1, {BATCH_TILE}]; got {batch_tile}")
    y = torch.empty((rows, B), dtype=acc_dtype(values.dtype), device=x.device)
    if rows == 0 or K == 0 or x.shape[0] == 0:
        y.zero_()
    else:
        fn = _build.library("ell_spmv")
        with torch.cuda.device(x.device):
            err = fn(colind.data_ptr(), values.data_ptr(), row_nnz.data_ptr(),
                     x.data_ptr(), y.data_ptr(), rows, K, x.shape[0], B, bt,
                     _build.DTYPE_CODES[values.dtype], _build.stream_of(x))
        _build.check(err, "ell_spmv")
        record_launch("ell", B)
    return y[:, 0] if squeeze else y


def ell_spmv(colind, values, row_nnz, x,
             batch_tile: int | None = None) -> torch.Tensor:
    """y = A @ x with A in ELL form (SpMV or multi-RHS SpMM).

    The signature of ``ell_spmv_pallas`` minus ``interpret`` and
    ``row_tile``: the plain version on a CPU tensor, the CUDA kernel on a
    CUDA tensor.  ``batch_tile`` (CUDA only) does not change the result.
    """
    if x.device.type == "cpu":
        return ell_spmv_plain(colind, values, row_nnz, x)
    return ell_spmv_cuda(colind, values, row_nnz, x, batch_tile)
