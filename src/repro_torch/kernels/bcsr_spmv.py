"""Block-sparse SpMV/SpMM (BCSR / BCOO): plain version and the CUDA
kernel's wrapper.

Counterpart of ``repro/kernels/bcsr_spmv.py``.  The TPU kernel took one grid
step per nonzero (r, c) block and accumulated each block-row in VMEM across
consecutive steps; the Hopper kernel (``csrc/bcoo_spmv.cu``, see its header
for the design and what bounds each route) walks each block-row's blocks
through a block-row pointer array: BCSR's ``browptr`` itself, or for BCOO
one built once from ``browind[:nblocks]`` (:func:`block_row_ptr`).  It has
three routes, chosen by :func:`block_route` from (dtype, r, c, B): a warp
per block-row with 128-bit loads for SpMV, tensor-core ``mma.sync`` for
floating-point SpMM, and a register-tiled CUDA-core kernel for the rest.

:func:`bcoo_spmv` dispatches on the device of ``x``: a CPU tensor runs the
plain version :func:`bcoo_spmv_plain`, a CUDA tensor launches the kernel
(:func:`bcoo_spmv_cuda`) or raises.

Blocks may carry a leading part axis (``bvalues`` (P, cap, r, c), one row
per part of a partitioned matrix): then one launch runs every part, each on
its own window of x (:class:`~repro_torch.kernels._build.XWindows`), and y
gains the part axis too.
"""
from __future__ import annotations

import torch

from . import _build
from .instrument import kernel_scope, record_launch, record_work
from .ref import acc_dtype, block_products

__all__ = ["bcoo_spmv", "bcoo_spmv_plain", "bcoo_spmv_cuda", "block_row_ptr",
           "transposed_stream", "transposed_values", "block_route", "route_takes", "ROUTES", "DEFAULT_BLOCK", "BATCH_TILE",
           "MMA_MIN_BATCH"]

DEFAULT_BLOCK = (8, 128)
BATCH_TILE = 32  # SpMM columns per thread tile of the CUDA-core route
# route -> its code in csrc/bcoo_spmv.cu (enum Route)
ROUTES = {"rows": 0, "warp": 1, "mma": 2}
MMA_MIN_BATCH = 8  # the smallest B that takes the tensor cores (PERF.md: faster at 8)


def route_takes(route: str, dtype: torch.dtype, r: int, c: int, B: int) -> bool:
    """Whether kernel route ``route`` can run (dtype, (r, c) blocks, B)."""
    if route == "warp":  # 4-column groups of a block tile the warp
        groups = r * c // 4
        return B == 1 and c % 4 == 0 and groups <= 32 and 32 % groups == 0
    if route == "mma":  # m16n8k8 (f32, 3xTF32) or m16n8k16 (bf16 / f16)
        if dtype == torch.float32:
            return r in (8, 16) and c % 8 == 0
        return dtype in (torch.bfloat16, torch.float16) and r in (8, 16) \
            and c % 16 == 0
    return route == "rows"


def block_route(dtype: torch.dtype, r: int, c: int, B: int) -> str:
    """The kernel route for (value dtype, block shape, batch columns).

    ``"warp"`` (a warp per block-row) for SpMV where the block's 4-column
    groups tile a warp; ``"mma"`` (tensor cores) for SpMM with
    B >= :data:`MMA_MIN_BATCH` where :func:`route_takes` allows it;
    ``"rows"`` (register-tiled CUDA cores) for everything else, integer
    values among them.  The route fixes the order of every sum; the batch
    tile does not.
    """
    if B == 1:
        return "warp" if route_takes("warp", dtype, r, c, B) else "rows"
    if B >= MMA_MIN_BATCH and route_takes("mma", dtype, r, c, B):
        return "mma"
    return "rows"


def block_row_ptr(browind: torch.Tensor, nblocks, n_brows: int) -> torch.Tensor:
    """(n_brows + 1,) int32 block-row pointer of a block-row-sorted stream;
    (P, n_brows + 1) for per-part streams ``browind`` (P, cap) with
    ``nblocks`` (P,)."""
    if browind.ndim == 2:
        return torch.stack([block_row_ptr(browind[p], nblocks[p], n_brows)
                            for p in range(browind.shape[0])])
    ptr = torch.zeros(n_brows + 1, dtype=torch.int64, device=browind.device)
    ptr[1:] = torch.bincount(browind[: int(nblocks)].long(), minlength=n_brows)
    return torch.cumsum(ptr, 0).to(torch.int32)


def transposed_stream(browind: torch.Tensor, bcolind: torch.Tensor,
                      n_bcols: int) -> tuple:
    """The static block stream of Wᵀ, from W's block-row-sorted stream.

    W's block k sits at (browind[k], bcolind[k]); in Wᵀ it is the
    transposed block at (bcolind[k], browind[k]).  Returns (perm,
    t_browind, t_bcolind, t_browptr), int32: Wᵀ's blocks are W's blocks
    ``perm``, sorted by block-column of W (stably, so each block-row of Wᵀ
    keeps W's block-row order); ``t_browptr`` (n_bcols + 1,) is Wᵀ's
    block-row pointer.  Only the values change as W trains:
    :func:`transposed_values` gathers them.  Stacked streams (L, nb) give
    one row per layer.

    The pattern balances W's block-rows, not its block-columns, so Wᵀ's
    block-rows hold unequal counts.
    """
    if browind.ndim == 2:
        rows = [transposed_stream(b, c, n_bcols) for b, c in zip(browind, bcolind)]
        return tuple(torch.stack(col) for col in zip(*rows))
    perm = torch.argsort(bcolind.long(), stable=True)
    t_browind = bcolind[perm].contiguous()
    t_bcolind = browind[perm].contiguous()
    t_browptr = block_row_ptr(t_browind, t_browind.shape[0], n_bcols)
    return perm.to(torch.int32), t_browind, t_bcolind, t_browptr


def transposed_values(bvalues: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Wᵀ's (nb, c, r) block values from W's (nb, r, c) and the stream's
    permutation: a gather and a transposing copy, no arithmetic."""
    return bvalues[perm.long()].transpose(-1, -2).contiguous()


def _pad_x(x: torch.Tensor, c: int) -> torch.Tensor:
    col_pad = -(-x.shape[0] // c) * c
    if col_pad == x.shape[0]:
        return x
    pad = torch.zeros((col_pad - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def bcoo_spmv_plain(browind, bcolind, bvalues, x, out_rows: int,
                    nblocks=None, windows=None) -> torch.Tensor:
    """The kernel's function in plain torch, on any device.

    x is zero-padded to a multiple of c; blocks at or past ``nblocks`` add
    nothing.  Returns y (out_rows[, B]) in the accumulation dtype; empty
    block-rows are zero.  Per-part blocks run part by part, part p on
    ``windows.local(x, p)`` (default: the whole x), and return y with a
    leading part axis.
    """
    if bvalues.ndim == 4:
        return torch.stack([
            bcoo_spmv_plain(browind[p], bcolind[p], bvalues[p],
                            x if windows is None else windows.local(x, p),
                            out_rows, None if nblocks is None else nblocks[p])
            for p in range(bvalues.shape[0])])
    if windows is not None:
        x = windows.local(x, 0)
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
                   batch_tile: int | None = None,
                   windows: _build.XWindows | None = None,
                   route: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on blocks and x that lie on one CUDA device.

    ``browptr`` is the (out_rows / r + 1,) block-row pointer; per-part
    blocks (``bvalues`` (P, cap, r, c)) take one pointer row per part and
    run in one launch, part p on its x window (``windows``; default: the
    whole x).  ``route`` (default :func:`block_route`) names the kernel;
    ``batch_tile`` is the CUDA-core route's and changes no bit.  Returns y
    ([P,] out_rows[, B]) in the accumulation dtype.

    Raises:
      ValueError/TypeError: wrong device, dtype, shape or contiguity
        (float64 and int64 values included: the kernel does not take them),
        x windows that overrun x, or a route that cannot take the shape.
      RuntimeError: the launch failed.
    """
    if x.device.type != "cuda":
        raise ValueError(f"bcoo_spmv_cuda needs a CUDA tensor; x is on {x.device}")
    _build.check_real("bcoo_spmv_cuda", x, bvalues)
    B, squeeze = _build.check_x(x, bvalues.dtype, "bcoo_spmv_cuda")
    _build.check_index(browptr, x.device, "browptr")
    _build.check_index(bcolind, x.device, "bcolind")
    stacked = bvalues.ndim == 4
    if bvalues.device != x.device or not bvalues.is_contiguous() \
            or bvalues.ndim - stacked != 3:
        raise ValueError(f"bvalues must be a contiguous ([P,] nb, r, c) tensor "
                         f"on {x.device}")
    n_parts = bvalues.shape[0] if stacked else 1
    cap, r, c = bvalues.shape[-3:]
    n_brows = out_rows // r
    parts = bvalues.shape[:-3]  # () or (P,)
    if out_rows % r or browptr.shape != parts + (n_brows + 1,) \
            or bcolind.shape != bvalues.shape[:-2]:
        raise ValueError(f"browptr has shape {tuple(browptr.shape)}; out_rows="
                         f"{out_rows} with r={r} needs {n_brows + 1} entries "
                         f"per part")
    x_off, n_cols = _build.check_windows(windows, n_parts, x, "bcoo_spmv_cuda")
    bt = min(B, BATCH_TILE if batch_tile is None else batch_tile)
    if not 1 <= bt <= BATCH_TILE:
        raise ValueError(f"batch_tile must be in [1, {BATCH_TILE}]; got {batch_tile}")
    route = block_route(bvalues.dtype, r, c, B) if route is None else route
    if route not in ROUTES or not route_takes(route, bvalues.dtype, r, c, B):
        raise ValueError(f"route {route!r} cannot take {bvalues.dtype} ({r}, {c}) "
                         f"blocks at B={B}")
    acc = acc_dtype(bvalues.dtype)
    y = torch.empty((n_parts, out_rows, B), dtype=acc, device=x.device)
    if n_brows == 0 or n_cols == 0:
        y.zero_()
    else:
        fn = _build.library("bcoo_spmv")
        with torch.cuda.device(x.device):
            err = fn(browptr.data_ptr(), bcolind.data_ptr(), bvalues.data_ptr(),
                     x.data_ptr(), y.data_ptr(), x_off, n_brows, r, c, n_cols, B,
                     bt, n_parts, cap, ROUTES[route],
                     _build.DTYPE_CODES[bvalues.dtype], _build.stream_of(x))
        _build.check(err, f"bcoo_spmv ({route} route)")
        record_launch("bcoo", B, bcoo_work(
            bvalues, x, out_rows,
            lambda: _build.nonzeros(browptr[..., -1], n_parts * cap)))
    y = y if stacked else y[0]
    return y[..., 0] if squeeze else y


def bcoo_spmv(browind, bcolind, bvalues, x, out_rows: int, nblocks=None,
              batch_tile: int | None = None, *, browptr=None,
              windows: _build.XWindows | None = None) -> torch.Tensor:
    """Block-sparse y = A @ x, A given as a block-row-sorted BCOO stream.

    The signature of ``bcoo_spmv_pallas`` minus ``interpret``: the plain
    version on a CPU tensor, the CUDA kernel on a CUDA tensor.  ``browptr``
    (CUDA only) skips rebuilding the block-row pointer from ``browind``;
    ``batch_tile`` (CUDA only) does not change the result.  Per-part blocks
    (a leading part axis) run every part, part p on its window of x
    (``windows``).
    """
    with kernel_scope():
        if x.device.type == "cpu":
            record_work("bcoo", bcoo_work(bvalues, x, out_rows,
                                          lambda: _blocks(bvalues, nblocks)))
            return bcoo_spmv_plain(browind, bcolind, bvalues, x, out_rows, nblocks,
                                   windows)
        if browptr is None:
            nb = nblocks
            if nb is None:
                nb = (bvalues.shape[0] if bvalues.ndim == 3
                      else [bvalues.shape[1]] * bvalues.shape[0])
            browptr = block_row_ptr(browind, nb, out_rows // bvalues.shape[-2])
        return bcoo_spmv_cuda(browptr, bcolind, bvalues, x, out_rows, batch_tile,
                              windows)


def _blocks(bvalues: torch.Tensor, nblocks) -> int:
    """The blocks a product runs: ``nblocks`` (an int, a list or tensor of
    per-part counts) or, without it, every stored block."""
    slots = bvalues.shape[:-2].numel()
    if nblocks is None:
        return slots
    if isinstance(nblocks, torch.Tensor):
        return _build.nonzeros(nblocks, slots)
    return int(sum(nblocks)) if bvalues.ndim == 4 else int(nblocks)


def bcoo_work(bvalues: torch.Tensor, x: torch.Tensor, out_rows: int, nb):
    """``() -> (flops, bytes)`` of a block product over ``nb()`` blocks:
    2 FLOPs a block element and column; each block's values and column,
    the block-row pointer, x and y once (:mod:`.instrument`)."""
    def work():
        r, c = bvalues.shape[-2:]
        n = nb()
        B = x.shape[1] if x.ndim == 2 else 1
        parts = bvalues.shape[0] if bvalues.ndim == 4 else 1
        y = parts * out_rows * B * acc_dtype(bvalues.dtype).itemsize
        ptr = parts * (out_rows // r + 1) * 4
        return (2 * n * r * c * B,
                n * (r * c * bvalues.element_size() + 4) + ptr
                + x.numel() * x.element_size() + y)
    return work
