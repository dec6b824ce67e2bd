"""Block-sparse SpMV/SpMM (BCSR / BCOO): plain version and the CUDA
kernel's wrapper.

Counterpart of ``repro/kernels/bcsr_spmv.py``.  The TPU kernel took one grid
step per nonzero (r, c) block and accumulated each block-row in VMEM across
consecutive steps; the Hopper kernel (``csrc/bcoo_spmv.cu``, see its header
for the design and what bounds it) gives each output row of a block-row one
thread per batch column, which walks the block-row's blocks through a
block-row pointer array: BCSR's ``browptr`` itself, or for BCOO one built
once from ``browind[:nblocks]`` (:func:`block_row_ptr`).

:func:`bcoo_spmv` dispatches on the device of ``x``: a CPU tensor runs the
plain version :func:`bcoo_spmv_plain`, a CUDA tensor launches the kernel
(:func:`bcoo_spmv_cuda`) or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .instrument import record_launch
from .ref import acc_dtype, block_products

__all__ = ["bcoo_spmv", "bcoo_spmv_plain", "bcoo_spmv_cuda", "block_row_ptr",
           "DEFAULT_BLOCK", "BATCH_TILE"]

DEFAULT_BLOCK = (8, 128)
BATCH_TILE = 32  # SpMM columns per thread tile (r * BATCH_TILE <= 1024)


def block_row_ptr(browind: torch.Tensor, nblocks, n_brows: int) -> torch.Tensor:
    """(n_brows + 1,) int32 block-row pointer of a block-row-sorted stream."""
    ptr = torch.zeros(n_brows + 1, dtype=torch.int64, device=browind.device)
    ptr[1:] = torch.bincount(browind[: int(nblocks)].long(), minlength=n_brows)
    return torch.cumsum(ptr, 0).to(torch.int32)


def _pad_x(x: torch.Tensor, c: int) -> torch.Tensor:
    col_pad = -(-x.shape[0] // c) * c
    if col_pad == x.shape[0]:
        return x
    pad = torch.zeros((col_pad - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def bcoo_spmv_plain(browind, bcolind, bvalues, x, out_rows: int,
                    nblocks=None) -> torch.Tensor:
    """The kernel's function in plain torch, on any device.

    x is zero-padded to a multiple of c; blocks at or past ``nblocks`` add
    nothing.  Returns y (out_rows[, B]) in the accumulation dtype; empty
    block-rows are zero.
    """
    nb_cap, r, c = bvalues.shape
    nb = nb_cap if nblocks is None else int(nblocks)
    acc = acc_dtype(bvalues.dtype)
    xb = _pad_x(x, c)
    xb = xb.reshape((xb.shape[0] // c, c) + tuple(x.shape[1:]))
    xg = xb[bcolind[:nb].long().clamp(0, xb.shape[0] - 1)]
    prod = block_products(bvalues[:nb], xg, acc)
    yb = torch.zeros((out_rows // r, r) + tuple(x.shape[1:]), dtype=acc,
                     device=x.device)
    yb.index_add_(0, browind[:nb].long(), prod)
    return yb.reshape((out_rows,) + tuple(x.shape[1:]))


def bcoo_spmv_cuda(browptr, bcolind, bvalues, x, out_rows: int,
                   batch_tile: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on blocks and x that lie on one CUDA device.

    ``browptr`` is the (out_rows / r + 1,) block-row pointer.  Returns y
    (out_rows[, B]) in the accumulation dtype.

    Raises:
      ValueError/TypeError: wrong device, dtype, shape or contiguity
        (float64 and int64 values included: the kernel does not take them).
      RuntimeError: the launch failed.
    """
    if x.device.type != "cuda":
        raise ValueError(f"bcoo_spmv_cuda needs a CUDA tensor; x is on {x.device}")
    B, squeeze = _build.check_x(x, bvalues.dtype, "bcoo_spmv_cuda")
    _build.check_index(browptr, x.device, "browptr")
    _build.check_index(bcolind, x.device, "bcolind")
    if bvalues.device != x.device or not bvalues.is_contiguous() \
            or bvalues.ndim != 3:
        raise ValueError(f"bvalues must be a contiguous (nb, r, c) tensor on "
                         f"{x.device}")
    _, r, c = bvalues.shape
    n_brows = out_rows // r
    if out_rows % r or browptr.shape[0] != n_brows + 1:
        raise ValueError(f"browptr has {browptr.shape[0]} entries; out_rows="
                         f"{out_rows} with r={r} needs {n_brows + 1}")
    bt = min(B, BATCH_TILE if batch_tile is None else batch_tile, 1024 // r)
    if not 1 <= bt <= BATCH_TILE:
        raise ValueError(f"batch_tile must be in [1, {BATCH_TILE}]; got {batch_tile}")
    acc = acc_dtype(bvalues.dtype)
    y = torch.empty((out_rows, B), dtype=acc, device=x.device)
    if n_brows == 0 or x.shape[0] == 0:
        y.zero_()
    else:
        fn = _build.library("bcoo_spmv")
        with torch.cuda.device(x.device):
            err = fn(browptr.data_ptr(), bcolind.data_ptr(), bvalues.data_ptr(),
                     x.data_ptr(), y.data_ptr(), n_brows, r, c, x.shape[0], B, bt,
                     _build.DTYPE_CODES[bvalues.dtype], _build.stream_of(x))
        _build.check(err, "bcoo_spmv")
        record_launch("bcoo", B)
    return y[:, 0] if squeeze else y


def bcoo_spmv(browind, bcolind, bvalues, x, out_rows: int, nblocks=None,
              batch_tile: int | None = None, *, browptr=None) -> torch.Tensor:
    """Block-sparse y = A @ x, A given as a block-row-sorted BCOO stream.

    The signature of ``bcoo_spmv_pallas`` minus ``interpret``: the plain
    version on a CPU tensor, the CUDA kernel on a CUDA tensor.  ``browptr``
    (CUDA only) skips rebuilding the block-row pointer from ``browind``;
    ``batch_tile`` (CUDA only) does not change the result.
    """
    if x.device.type == "cpu":
        return bcoo_spmv_plain(browind, bcolind, bvalues, x, out_rows, nblocks)
    if browptr is None:
        nb = bvalues.shape[0] if nblocks is None else nblocks
        browptr = block_row_ptr(browind, nb, out_rows // bvalues.shape[1])
    return bcoo_spmv_cuda(browptr, bcolind, bvalues, x, out_rows, batch_tile)
