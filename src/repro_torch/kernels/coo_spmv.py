"""Windowed, element-granular COO SpMV/SpMM: chunk planner, piece table,
plain version and the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/coo_spmv.py``.  The host side is the same:
the row-sorted nonzero stream is cut into *chunks* of at most E elements,
each confined to one output *window* of SPAN rows (:func:`plan_chunks`
builds, array for array, the JAX package's :class:`ChunkPlan`).  The TPU
kernel merged each chunk into its window with a one-hot MXU matmul, one
grid step per chunk.  The Hopper kernel (``csrc/coo_spmv.cu``, see its
header for the design and what bounds it) balances nonzeros across SMs: each
window's chunk range is cut into *pieces* of at most
:data:`PIECE_CHUNKS` chunks (:func:`plan_pieces`, built once with the
plan), one CTA per (piece, batch tile), and the pieces of a split window
are summed in piece order by a second pass.  No atomics.

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
from torch._subclasses.fake_tensor import is_fake

from ..core.formats import to_tensor
from . import _build
from .instrument import kernel_scope, record_launch, record_work
from .ref import acc_dtype

__all__ = ["ChunkPlan", "plan_chunks", "plan_pieces", "stack_chunk_plans",
           "coo_spmv", "coo_spmv_plain", "coo_spmv_cuda", "CHUNK_E", "ROW_SPAN",
           "BATCH_TILE", "PIECE_CHUNKS"]

CHUNK_E = 512  # nnz per chunk
ROW_SPAN = 512  # output window height
BATCH_TILE = 32  # SpMM columns per CTA (one per lane of the CUDA kernel)
# chunks per piece: a regular window (16 chunks) stays whole, and a
# scale-free matrix ran fastest at 16 of 8..128 on the H100 (chip_smoke.py's
# piece-size sweep)
PIECE_CHUNKS = 16
MAX_CHUNK_E = 2048  # widest chunk the CUDA kernel takes (its product buffer)


@dataclass(frozen=True)
class ChunkPlan:
    """Host-side chunking of a row-sorted COO stream (static per matrix).

    Fields as in the JAX package, as tensors, plus three the port derives
    once, here, when they are not given: ``window_start`` brackets each
    window's contiguous chunk range (window ids are non-decreasing), and
    ``pieces`` / ``splits`` are the CUDA kernel's piece table
    (:func:`plan_pieces`).  A stacked plan
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
    pieces: torch.Tensor = None  # (Q, 4) int32, see plan_pieces
    splits: torch.Tensor = None  # (Z, 3) int32, see plan_pieces

    def __post_init__(self):
        if self.window_start is None:
            w = torch.arange(self.n_windows + 1, dtype=torch.int32,
                             device=self.window.device)
            w = w.expand(self.window.shape[:-1] + w.shape).contiguous()
            ws = torch.searchsorted(self.window.contiguous(), w).to(torch.int32)
            object.__setattr__(self, "window_start", ws)
        if self.pieces is None or self.splits is None:
            pieces, splits = plan_pieces(self.window_start)
            dev = self.window_start.device
            object.__setattr__(self, "pieces", pieces.to(dev))
            object.__setattr__(self, "splits", splits.to(dev))

    _tensors = ("rowind", "colind", "values", "window", "count", "window_start",
                "pieces", "splits")

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


def plan_pieces(window_start, max_chunks: int = PIECE_CHUNKS):
    """The CUDA kernel's piece table: each window's chunk range cut into
    pieces of at most ``max_chunks`` chunks (host side, once per plan).

    ``window_start`` is ([P,] n_windows + 1).  A window of n chunks becomes
    ceil(n / max_chunks) pieces of near-equal size (at least one, so that
    an empty window still writes its zeros), contiguous and in chunk order.
    The pieces of a split window (more than one piece) each own a scratch
    slot, numbered per part in piece order.

    Returns ``(pieces, splits)``, int32 CPU tensors with the part axis of
    ``window_start``:

      * ``pieces`` ([P,] Q, 4): window, first chunk, end chunk, scratch
        slot (-1 when the window is a single piece and writes y itself);
      * ``splits`` ([P,] Z, 3): one row per scratch slot: window, the first
        and the end slot of that window's pieces.

    Parts with fewer pieces or slots are padded with rows whose window is
    -1 (Q, Z: the most over the parts; Z may be 0).
    """
    if max_chunks < 1:
        raise ValueError(f"max_chunks must be >= 1; got {max_chunks}")
    ws = np.asarray(torch.as_tensor(window_start).cpu(), np.int64)
    stacked = ws.ndim == 2
    per_part = []
    for w_start in (ws if stacked else ws[None]):
        n = np.diff(w_start)  # chunks per window
        k = np.maximum(1, -(-n // max_chunks))  # pieces per window
        win = np.repeat(np.arange(len(n)), k)
        first = np.repeat(np.cumsum(k) - k, k)  # first piece of each window
        i, kw, nw = np.arange(len(win)) - first, k[win], n[win]
        lo = w_start[win] + i * nw // kw
        hi = w_start[win] + (i + 1) * nw // kw
        split = kw > 1
        slot = np.full(len(win), -1, np.int64)
        slot[split] = np.arange(int(split.sum()))
        s_lo = slot[split] - i[split]
        per_part.append((np.stack([win, lo, hi, slot], 1),
                         np.stack([win[split], s_lo, s_lo + kw[split]], 1)))
    Q = max(len(p) for p, _ in per_part)
    Z = max(len(s) for _, s in per_part)
    pieces = np.tile(np.array([-1, 0, 0, -1], np.int32), (len(per_part), Q, 1))
    splits = np.tile(np.array([-1, 0, 0], np.int32), (len(per_part), Z, 1))
    for p, (pc, sp) in enumerate(per_part):
        pieces[p, : len(pc)] = pc
        splits[p, : len(sp)] = sp
    if not stacked:
        pieces, splits = pieces[0], splits[0]
    return torch.from_numpy(pieces), torch.from_numpy(splits)


def stack_chunk_plans(plans) -> dict:
    """Stack per-part ChunkPlans with a leading part axis.

    The JAX package's function, array for array: every plan must share
    span / n_windows / out_rows / chunk width; parts with fewer chunks are
    padded with empty chunks (count 0) whose window id repeats the part's
    last real window.  Returns a dict of host tensors — ``window`` /
    ``count`` (P, n_chunks), ``rowind`` / ``colind`` / ``values``
    (P, n_chunks, E) — plus ``window_start`` (P, n_windows + 1), each
    part's own window brackets over its real chunks, the stacked piece
    table ``pieces`` / ``splits`` (:func:`plan_pieces` over those brackets,
    so the count-0 padding chunks lie in no piece), and the shared static
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
    out["pieces"], out["splits"] = plan_pieces(out["window_start"])
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

    One launch covers every piece, batch tile and, for a stacked plan, every
    part (part p on its x window, ``windows``; default: the whole x), and is
    followed by the merge of split windows when the plan has any; an empty
    plan launches nothing.  The scratch of split windows comes from torch's
    caching allocator.  Returns y ([P,] out_rows[, B]) in the accumulation
    dtype.

    Raises:
      ValueError/TypeError: wrong device, dtype, shape or contiguity
        (float64 and int64 values included: the kernel does not take them),
        a chunk wider than ``MAX_CHUNK_E``, or x windows that overrun x.
      RuntimeError: the launch failed.
    """
    if x.device.type != "cuda":
        raise ValueError(f"coo_spmv_cuda needs a CUDA tensor; x is on {x.device}")
    _build.check_real("coo_spmv_cuda", x, plan.values)
    B, squeeze = _build.check_x(x, plan.values.dtype, "coo_spmv_cuda")
    for f in ("rowind", "colind", "count", "pieces", "splits"):
        _build.check_index(getattr(plan, f), x.device, f"plan.{f}")
    if plan.values.device != x.device or not plan.values.is_contiguous():
        raise ValueError(f"plan.values must be contiguous on {x.device}")
    n_parts = plan.n_parts or 1
    lead = plan.rowind.shape[:-1]  # ([P,] n_chunks)
    E = plan.rowind.shape[-1]
    if plan.count.shape != lead or plan.colind.shape != plan.rowind.shape \
            or plan.values.shape != plan.rowind.shape \
            or plan.pieces.shape[:-2] != lead[:-1] or plan.pieces.shape[-1] != 4 \
            or plan.splits.shape[:-2] != lead[:-1] or plan.splits.shape[-1] != 3 \
            or plan.pieces.data_ptr() % 16:
        raise ValueError(f"plan arrays disagree: rowind {tuple(plan.rowind.shape)}, "
                         f"count {tuple(plan.count.shape)}, pieces "
                         f"{tuple(plan.pieces.shape)}, splits "
                         f"{tuple(plan.splits.shape)}")
    if E > MAX_CHUNK_E:
        raise ValueError(f"coo_spmv_cuda takes chunks of at most {MAX_CHUNK_E} "
                         f"elements; the plan's are {E}")
    x_off, n_cols = _build.check_windows(windows, n_parts, x, "coo_spmv_cuda")
    bt = min(B, BATCH_TILE if batch_tile is None else batch_tile)
    if not 1 <= bt <= BATCH_TILE:
        raise ValueError(f"batch_tile must be in [1, {BATCH_TILE}]; got {batch_tile}")
    acc = acc_dtype(plan.values.dtype)
    y = torch.empty((n_parts, plan.out_rows, B), dtype=acc, device=x.device)
    Q, Z = plan.pieces.shape[-2], plan.splits.shape[-2]
    if plan.n_chunks == 0 or plan.out_rows == 0 or n_cols == 0 or Q == 0:
        y.zero_()
    else:
        scratch = (torch.empty((n_parts, Z, plan.span, B), dtype=acc,
                               device=x.device) if Z else None)
        fn = _build.library("coo_spmv")
        with torch.cuda.device(x.device):
            err = fn(plan.pieces.data_ptr(), plan.splits.data_ptr(),
                     plan.count.data_ptr(), plan.rowind.data_ptr(),
                     plan.colind.data_ptr(), plan.values.data_ptr(), x.data_ptr(),
                     y.data_ptr(), x_off,
                     None if scratch is None else scratch.data_ptr(), Q, Z, E,
                     plan.span, plan.out_rows, n_cols, B, bt, n_parts,
                     plan.n_chunks, _build.DTYPE_CODES[plan.values.dtype],
                     _build.stream_of(x))
        _build.check(err, "coo_spmv")
        record_launch("coo", B, coo_work(plan, x))
    y = y if plan.n_parts is not None else y[0]
    return y[..., 0] if squeeze else y


def coo_work(plan: ChunkPlan, x: torch.Tensor):
    """``() -> (flops, bytes)`` of ``plan @ x``: 2 FLOPs a nonzero and
    column; each nonzero's row, column and value, x and y once
    (:mod:`.instrument`)."""
    def work():
        B = x.shape[1] if x.ndim == 2 else 1
        nnz = _build.nonzeros(plan.count, plan.values.numel())
        y = (plan.n_parts or 1) * plan.out_rows * B * acc_dtype(plan.values.dtype).itemsize
        return (2 * nnz * B,
                nnz * (8 + plan.values.element_size()) + x.numel() * x.element_size() + y)
    return work


def coo_spmv(plan: ChunkPlan, x: torch.Tensor, batch_tile: int | None = None,
             windows: _build.XWindows | None = None) -> torch.Tensor:
    """y = plan @ x: the plain version on a CPU tensor, the CUDA kernel on a
    CUDA tensor.  ``batch_tile`` (CUDA only) sets the SpMM columns per CTA;
    the result does not depend on it.  ``windows`` gives each part of a
    stacked plan its window of x.  A fake CPU x (a count,
    ``analysis/count.py``) gets a fake y of the result's shape."""
    with kernel_scope():
        if x.device.type == "cpu":
            record_work("coo", coo_work(plan, x))
            if is_fake(x):  # the plain version's masks need data: y's shape only
                lead = () if plan.n_parts is None else (plan.n_parts,)
                return x.new_zeros(lead + (plan.out_rows,) + tuple(x.shape[1:]),
                                   dtype=acc_dtype(plan.values.dtype))
            return coo_spmv_plain(plan, x, windows)
        return coo_spmv_cuda(plan, x, batch_tile, windows)
