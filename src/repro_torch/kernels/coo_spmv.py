"""Windowed, element-granular COO SpMV/SpMM: chunk planner, plain version
and the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/coo_spmv.py``.  The host side is the same:
the row-sorted nonzero stream is cut into *chunks* of at most E elements,
each confined to one output *window* of SPAN rows (:func:`plan_chunks`
builds, array for array, the JAX package's :class:`ChunkPlan`).  The TPU
kernel merged each chunk into its window with a one-hot MXU matmul; the
Hopper kernel (``csrc/coo_spmv.cu``, see its header for the design and what
bounds it) merges with a warp-level segmented reduction instead, one CTA
per (window, batch tile), no atomics.

:func:`coo_spmv` dispatches on the device of ``x``: a CPU tensor runs the
plain version :func:`coo_spmv_plain`, a CUDA tensor launches the kernel
(:func:`coo_spmv_cuda`) or raises.

A plan may carry a leading part axis (:func:`stack_chunk_plans`, one plan
per part of a partitioned matrix): then one launch runs every part, each on
its own window of x (:class:`~repro_torch.kernels._build.XWindows`), and y
gains the part axis too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.formats import to_tensor
from . import _build
from .instrument import record_launch
from .ref import acc_dtype

__all__ = ["ChunkPlan", "plan_chunks", "stack_chunk_plans", "coo_spmv",
           "coo_spmv_plain", "coo_spmv_cuda", "CHUNK_E", "ROW_SPAN",
           "BATCH_TILE"]

CHUNK_E = 512  # nnz per chunk
ROW_SPAN = 512  # output window height
BATCH_TILE = 32  # SpMM columns per CTA (register tile of the CUDA kernel)


@dataclass(frozen=True)
class ChunkPlan:
    """Host-side chunking of a row-sorted COO stream (static per matrix).

    Fields as in the JAX package, as tensors; ``window_start`` (built once,
    here) brackets each window's contiguous chunk range — window ids are
    non-decreasing — for the CUDA kernel's per-window CTAs.  A stacked plan
    (:func:`stack_chunk_plans`) has a leading part axis on every tensor.
    """

    rowind: torch.Tensor  # (n_chunks, E) int32 — rows, relative to window start
    colind: torch.Tensor  # (n_chunks, E) int32
    values: torch.Tensor  # (n_chunks, E)
    window: torch.Tensor  # (n_chunks,)  int32 — output window id per chunk
    count: torch.Tensor  # (n_chunks,)  int32 — real elements per chunk
    n_windows: int
    out_rows: int
    span: int = ROW_SPAN
    window_start: torch.Tensor = None  # (n_windows + 1,) int32

    def __post_init__(self):
        if self.window_start is None:
            w = torch.arange(self.n_windows + 1, dtype=torch.int32,
                             device=self.window.device)
            w = w.expand(self.window.shape[:-1] + w.shape).contiguous()
            ws = torch.searchsorted(self.window.contiguous(), w).to(torch.int32)
            object.__setattr__(self, "window_start", ws)

    _tensors = ("rowind", "colind", "values", "window", "count", "window_start")

    def to(self, device) -> "ChunkPlan":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._tensors})

    @property
    def n_chunks(self) -> int:
        """Chunks (per part, for a stacked plan)."""
        return self.rowind.shape[-2]

    @property
    def n_parts(self) -> int | None:
        """Parts of a stacked plan; None for a single plan."""
        return self.rowind.shape[0] if self.rowind.ndim == 3 else None

    def part(self, p: int) -> "ChunkPlan":
        """Part ``p`` of a stacked plan, as a single plan (views)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[p] for f in self._tensors})


def plan_chunks(
    rowind,
    colind,
    values,
    out_rows: int,
    chunk: int = CHUNK_E,
    span: int = ROW_SPAN,
    row_granular: bool = False,
) -> ChunkPlan:
    """Cut a row-sorted COO stream into window-confined chunks.

    row_granular=True keeps whole rows inside one chunk where possible
    (CSR.row / *.nnz-rgrn semantics); False splits anywhere (COO.nnz perfect
    balance).  Rows longer than ``chunk`` split regardless (paper Obs. 4).
    ``values`` may be a tensor (any dtype, bfloat16 included) or an array.
    """
    rowind = np.asarray(rowind, np.int64)
    colind = np.asarray(colind, np.int64)
    values = to_tensor(values)
    nnz = len(rowind)
    n_windows = max(1, -(-out_rows // span))

    # chunk boundaries: never cross a window boundary; at most `chunk` long.
    bounds = [0]
    while bounds[-1] < nnz:
        lo = bounds[-1]
        w = rowind[lo] // span
        # furthest element still inside window w
        hi_win = int(np.searchsorted(rowind, (w + 1) * span, side="left"))
        hi = min(lo + chunk, hi_win)
        if row_granular and hi < hi_win:
            # retreat to a row boundary (keep rows whole) unless that empties
            # the chunk (row longer than `chunk`)
            back = int(np.searchsorted(rowind, rowind[hi], side="left"))
            if back > lo:
                hi = back
        bounds.append(hi)
    bounds = np.asarray(bounds, np.int64)
    n_chunks = len(bounds) - 1

    cnt = np.diff(bounds)
    win = rowind[bounds[:-1]] // span if n_chunks else np.zeros(0, np.int64)
    which = np.repeat(np.arange(n_chunks), cnt)  # chunk of every element
    pos = np.arange(nnz) - bounds[:-1][which]  # its slot in the chunk
    ri = np.zeros((n_chunks, chunk), np.int32)
    ci = np.zeros((n_chunks, chunk), np.int32)
    ri[which, pos] = rowind - win[which] * span  # window-relative
    ci[which, pos] = colind
    vv = torch.zeros((n_chunks, chunk), dtype=values.dtype)
    vv[torch.from_numpy(which), torch.from_numpy(pos)] = values[:nnz]
    return ChunkPlan(torch.from_numpy(ri), torch.from_numpy(ci), vv,
                     torch.from_numpy(win.astype(np.int32)),
                     torch.from_numpy(cnt.astype(np.int32)),
                     n_windows, out_rows, span)


def stack_chunk_plans(plans) -> dict:
    """Stack per-part ChunkPlans with a leading part axis.

    The JAX package's function, array for array: every plan must share
    span / n_windows / out_rows / chunk width; parts with fewer chunks are
    padded with empty chunks (count 0) whose window id repeats the part's
    last real window.  Returns a dict of host tensors — ``window`` /
    ``count`` (P, n_chunks), ``rowind`` / ``colind`` / ``values``
    (P, n_chunks, E) — plus ``window_start`` (P, n_windows + 1), each
    part's own window brackets over its real chunks, and the shared static
    ``span`` / ``n_windows`` / ``out_rows``.  ``ChunkPlan(**stacked)`` is
    the stacked plan one part-axis launch runs.

    Raises:
      ValueError: no plans, or plans with mismatched metadata.
    """
    if not plans:
        raise ValueError("stack_chunk_plans needs at least one plan")
    first = plans[0]
    meta = (first.span, first.n_windows, first.out_rows, first.rowind.shape[1])
    if any((p.span, p.n_windows, p.out_rows, p.rowind.shape[1]) != meta
           for p in plans[1:]):
        raise ValueError("per-shard chunk plans have mismatched metadata")
    E = first.rowind.shape[1]
    nc = max(1, max(p.n_chunks for p in plans))
    Pn = len(plans)
    out = dict(rowind=torch.zeros((Pn, nc, E), dtype=torch.int32),
               colind=torch.zeros((Pn, nc, E), dtype=torch.int32),
               values=torch.zeros((Pn, nc, E), dtype=first.values.dtype),
               window=torch.zeros((Pn, nc), dtype=torch.int32),
               count=torch.zeros((Pn, nc), dtype=torch.int32))
    for p, plan in enumerate(plans):
        n = plan.n_chunks
        for f in ("rowind", "colind", "values", "window", "count"):
            out[f][p, :n] = getattr(plan, f)
        if n:  # padding chunks revisit the last real window with count 0
            out["window"][p, n:] = plan.window[-1]
    out["window_start"] = torch.stack([p.window_start for p in plans])
    return dict(out, span=first.span, n_windows=first.n_windows,
                out_rows=first.out_rows)


def coo_spmv_plain(plan: ChunkPlan, x: torch.Tensor,
                   windows: _build.XWindows | None = None) -> torch.Tensor:
    """The kernel's function in plain torch, on any device.

    Returns y of shape (out_rows,) or (out_rows, B) in the accumulation
    dtype; windows no chunk touches are zero.  A stacked plan runs part by
    part, part p on ``windows.local(x, p)`` (default: the whole x), and
    returns y with a leading part axis.
    """
    if plan.n_parts is not None:
        return torch.stack([
            coo_spmv_plain(plan.part(p), x if windows is None
                           else windows.local(x, p))
            for p in range(plan.n_parts)])
    if windows is not None:
        x = windows.local(x, 0)
    acc = acc_dtype(plan.values.dtype)
    E = plan.rowind.shape[1]
    mask = torch.arange(E, device=plan.count.device) < plan.count[:, None]
    rows = (plan.window[:, None].long() * plan.span + plan.rowind)[mask]
    cols = plan.colind[mask].long().clamp(0, x.shape[0] - 1)
    vals = plan.values[mask].to(acc)
    prod = vals.reshape(vals.shape + (1,) * (x.ndim - 1)) * x[cols].to(acc)
    y = torch.zeros((plan.n_windows * plan.span,) + tuple(x.shape[1:]),
                    dtype=acc, device=x.device)
    return y.index_add_(0, rows, prod)[: plan.out_rows]


def coo_spmv_cuda(plan: ChunkPlan, x: torch.Tensor,
                  batch_tile: int | None = None,
                  windows: _build.XWindows | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on a plan and x that lie on one CUDA device.

    One launch covers every batch tile and, for a stacked plan, every part
    (part p on its x window, ``windows``; default: the whole x); an empty
    plan launches nothing.  Returns y ([P,] out_rows[, B]) in the
    accumulation dtype.

    Raises:
      ValueError/TypeError: wrong device, dtype, shape or contiguity
        (float64 and int64 values included: the kernel does not take them),
        or x windows that overrun x.
      RuntimeError: the launch failed.
    """
    if x.device.type != "cuda":
        raise ValueError(f"coo_spmv_cuda needs a CUDA tensor; x is on {x.device}")
    B, squeeze = _build.check_x(x, plan.values.dtype, "coo_spmv_cuda")
    for f in ("rowind", "colind", "window_start", "count"):
        _build.check_index(getattr(plan, f), x.device, f"plan.{f}")
    if plan.values.device != x.device or not plan.values.is_contiguous():
        raise ValueError(f"plan.values must be contiguous on {x.device}")
    n_parts = plan.n_parts or 1
    lead = plan.rowind.shape[:-1]  # ([P,] n_chunks)
    if plan.window_start.shape != lead[:-1] + (plan.n_windows + 1,) \
            or plan.count.shape != lead or plan.colind.shape != plan.rowind.shape \
            or plan.values.shape != plan.rowind.shape:
        raise ValueError(f"plan arrays disagree: rowind {tuple(plan.rowind.shape)}, "
                         f"count {tuple(plan.count.shape)}, window_start "
                         f"{tuple(plan.window_start.shape)} for {plan.n_windows} "
                         f"windows")
    x_off, n_cols = _build.check_windows(windows, n_parts, x, "coo_spmv_cuda")
    bt = min(B, BATCH_TILE if batch_tile is None else batch_tile)
    if not 1 <= bt <= BATCH_TILE:
        raise ValueError(f"batch_tile must be in [1, {BATCH_TILE}]; got {batch_tile}")
    acc = acc_dtype(plan.values.dtype)
    y = torch.empty((n_parts, plan.out_rows, B), dtype=acc, device=x.device)
    if plan.n_chunks == 0 or plan.out_rows == 0 or n_cols == 0:
        y.zero_()
    else:
        fn = _build.library("coo_spmv")
        with torch.cuda.device(x.device):
            err = fn(plan.window_start.data_ptr(), plan.count.data_ptr(),
                     plan.rowind.data_ptr(), plan.colind.data_ptr(),
                     plan.values.data_ptr(), x.data_ptr(), y.data_ptr(), x_off,
                     plan.n_windows, plan.rowind.shape[-1], plan.span,
                     plan.out_rows, n_cols, B, bt, n_parts, plan.n_chunks,
                     _build.DTYPE_CODES[plan.values.dtype], _build.stream_of(x))
        _build.check(err, "coo_spmv")
        record_launch("coo", B)
    y = y if plan.n_parts is not None else y[0]
    return y[..., 0] if squeeze else y


def coo_spmv(plan: ChunkPlan, x: torch.Tensor, batch_tile: int | None = None,
             windows: _build.XWindows | None = None) -> torch.Tensor:
    """y = plan @ x: the plain version on a CPU tensor, the CUDA kernel on a
    CUDA tensor.  ``batch_tile`` (CUDA only) sets the SpMM columns per CTA;
    the result does not depend on it.  ``windows`` gives each part of a
    stacked plan its window of x."""
    if x.device.type == "cpu":
        return coo_spmv_plain(plan, x, windows)
    return coo_spmv_cuda(plan, x, batch_tile, windows)
