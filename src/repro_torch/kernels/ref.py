"""Plain torch oracles for the SpMV kernels — the ``impl="torch"`` path.

Counterpart of ``repro/kernels/ref.py`` (its ``impl="xla"`` path).  They run
on any device and hold the same conventions:

  * index arrays may be padded past ``nnz``; contributions at k >= nnz are
    masked to zero;
  * ``x`` may be a vector (n,) or a batch (n, B) — SpMV or SpMM;
  * output length/height is passed explicitly;
  * products and sums are taken in the accumulation dtype (bf16/f16 -> f32,
    i8/i16 -> i32) and cast back to the values dtype at the end.
"""
from __future__ import annotations

import torch

__all__ = [
    "acc_dtype",
    "coo_spmv_ref",
    "csr_spmv_ref",
    "bcoo_spmv_ref",
    "bcsr_spmv_ref",
    "ell_spmv_ref",
]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for low-precision floats, i32 for small ints.

    Mirrors the paper's observation that the DPU multiplies in a wider unit
    (8x8->16 multiplier with 32-bit accumulate).
    """
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    if dtype in (torch.int8, torch.int16):
        return torch.int32
    return dtype


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append ``ndim - 1`` trailing unit axes (broadcast over the batch)."""
    return t.reshape(t.shape + (1,) * (ndim - 1))


def _scatter_rows(index: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """zeros(n, ...).index_add_(0, index, src), dropping out-of-range rows."""
    index = index.long()
    ok = (index >= 0) & (index < n)
    src = torch.where(_bcast(ok, src.ndim), src, torch.zeros((), dtype=src.dtype,
                                                             device=src.device))
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, index.clamp(0, max(n - 1, 0)), src)


def coo_spmv_ref(rowind, colind, values, x, out_rows: int, nnz=None):
    """COO SpMV/SpMM: y[r] = sum_k values[k] * x[colind[k]] for rowind[k]==r
    (gather + ``index_add_``)."""
    cap = values.shape[0]
    acc = acc_dtype(values.dtype)
    xv = x[colind.long().clamp(0, x.shape[0] - 1)].to(acc)
    prod = _bcast(values.to(acc), x.ndim) * xv
    if nnz is not None:
        valid = torch.arange(cap, device=values.device) < nnz
        prod = torch.where(_bcast(valid, x.ndim), prod,
                           torch.zeros((), dtype=acc, device=prod.device))
    y = _scatter_rows(rowind, prod, out_rows)
    return y.to(values.dtype) if values.dtype != acc else y


def csr_spmv_ref(rowptr, colind, values, x, out_rows: int | None = None):
    """CSR SpMV/SpMM via rowptr expansion."""
    out_rows = out_rows if out_rows is not None else rowptr.shape[0] - 1
    k = torch.arange(values.shape[0], dtype=rowptr.dtype, device=rowptr.device)
    rowind = torch.searchsorted(rowptr, k, right=True) - 1
    rowind = rowind.clamp(0, out_rows - 1)
    return coo_spmv_ref(rowind, colind, values, x, out_rows, nnz=rowptr[-1])


def block_products(bvalues: torch.Tensor, xg: torch.Tensor, acc) -> torch.Tensor:
    """Per-block (r, c) @ (c, ...) products in ``acc``: (nb, r, c) x (nb, c, ...)
    -> (nb, r, ...).

    ``einsum`` for floating types; integer types take a loop over c, because
    CUDA's batched matmul has no integer kernel (the loop also wraps like
    int32 arithmetic).
    """
    a = bvalues.to(acc)
    xg = xg.to(acc)
    if acc.is_floating_point:
        return torch.einsum("krc,kc...->kr...", a, xg)
    r, c = a.shape[1:]
    out = torch.zeros((a.shape[0], r) + tuple(xg.shape[2:]), dtype=acc,
                      device=a.device)
    for k in range(c):
        out += _bcast(a[:, :, k], xg.ndim - 1) * xg[:, k].unsqueeze(1)
    return out


def bcoo_spmv_ref(browind, bcolind, bvalues, x, out_rows: int, nblocks=None):
    """BCOO SpMV/SpMM: per-block products + block ``index_add_``.

    y[browind[k]*r : +r] += bvalues[k] @ x[bcolind[k]*c : +c]
    """
    nb_cap, r, c = bvalues.shape
    acc = acc_dtype(bvalues.dtype)
    xb = x.reshape((x.shape[0] // c, c) + tuple(x.shape[1:]))
    xg = xb[bcolind.long().clamp(0, xb.shape[0] - 1)]
    prod = block_products(bvalues, xg, acc)
    if nblocks is not None:
        valid = torch.arange(nb_cap, device=bvalues.device) < nblocks
        prod = torch.where(_bcast(valid, prod.ndim), prod,
                           torch.zeros((), dtype=acc, device=prod.device))
    yb = _scatter_rows(browind, prod, out_rows // r)
    y = yb.reshape((out_rows,) + tuple(x.shape[1:]))
    return y.to(bvalues.dtype) if bvalues.dtype != acc else y


def bcsr_spmv_ref(browptr, bcolind, bvalues, x, out_rows: int | None = None):
    """BCSR SpMV/SpMM via browptr expansion to block rows."""
    r = bvalues.shape[1]
    out_rows = out_rows if out_rows is not None else (browptr.shape[0] - 1) * r
    k = torch.arange(bvalues.shape[0], dtype=browptr.dtype, device=browptr.device)
    browind = torch.searchsorted(browptr, k, right=True) - 1
    browind = browind.clamp(0, out_rows // r - 1)
    return bcoo_spmv_ref(browind, bcolind, bvalues, x, out_rows,
                         nblocks=browptr[-1])


def ell_spmv_ref(colind, values, x, row_nnz=None):
    """ELL (padded-row) SpMV/SpMM: gather + row sum, no scatter.

    colind/values: (rows, K); contributions at k >= row_nnz[r] are masked;
    columns are clipped to x's rows (``take(mode="clip")``).
    """
    rows, K = values.shape
    acc = acc_dtype(values.dtype)
    xv = x[colind.long().clamp(0, x.shape[0] - 1)].to(acc)
    prod = _bcast(values.to(acc), x.ndim) * xv
    if row_nnz is not None:
        mask = torch.arange(K, device=values.device)[None, :] < row_nnz[:, None]
        prod = torch.where(_bcast(mask, x.ndim), prod,
                           torch.zeros((), dtype=acc, device=prod.device))
    y = prod.sum(1, dtype=acc)
    return y.to(values.dtype) if values.dtype != acc else y
