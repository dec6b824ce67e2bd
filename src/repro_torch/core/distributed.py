"""Partitioned SpMV: the paper's load / kernel / retrieve-merge (Fig. 4)
over the P parts of a :class:`~repro_torch.core.partition.PartitionedMatrix`.

Counterpart of ``repro/core/distributed.py``.  The JAX package runs one
part per device under ``shard_map``; here every part of a mesh lies on one
torch device (:mod:`repro_torch.core.mesh`), so each collective becomes a
tensor operation on the part axis:

  paper step / JAX collective     | on one device
  --------------------------------+--------------------------------------
  load: all_gather(x) (1D)        | every part reads the whole x
  load: x sharded over columns    | part (r, c) reads its window of x
  (2D), all_gather + re-slice     | (XWindows: offset + length per part)
  (variable-sized)                |
  kernel: per-device tile kernel  | ONE part-axis launch of the CUDA kernel
                                  | (blockIdx.z = part), or the torch
                                  | oracles part by part
  merge: ppermute (1D nnz)        | shift of the boundary rows by one part
  merge: psum / psum_scatter      | sum over the C parts of a grid row,
                                  | in column order, in the values dtype
  merge: psum over the mesh       | scatter-add of every part's rows into
  (global)                        | one (rows, ...) buffer, in part order

As in the reference, each part's y is cast to the values dtype *before* the
merge, so bfloat16 partials are summed in bfloat16 and int8 in int8.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..kernels import ref as kref
from ..kernels.bcsr_spmv import bcoo_spmv, bcoo_spmv_plain, block_row_ptr
from ..kernels.coo_spmv import (CHUNK_E, ROW_SPAN, ChunkPlan, coo_spmv,
                                coo_spmv_plain, plan_chunks, stack_chunk_plans)
from .partition import PartitionedMatrix

__all__ = [
    "SpmvOutput",
    "LocalKernel",
    "place_1d",
    "place_2d",
    "spmv_1d",
    "spmv_2d",
    "spmv_1d_ring",
    "assemble_rows",
    "bucket_by_source_shard",
    "PartitionedProgram",
    "kernel_chunk_arrays",
    "kernel_block_arrays",
]


@dataclass(frozen=True)
class SpmvOutput:
    """Partitioned SpMV result: per-part output slices + placement metadata."""

    y_parts: torch.Tensor  # (P, h_pad[, B]) | (R, C, ...) for 2D merges
    row_start: np.ndarray  # (P,) host copy for assembly
    row_extent: np.ndarray  # (P,)
    rows: int
    merge: str = "none"  # none | psum | psum_scatter | global
    replicated_global: Optional[torch.Tensor] = None  # 2D merge="global"


def _tail(x: torch.Tensor) -> tuple:
    return tuple(x.shape[1:])


# ---------------------------------------------------------------------------
# per-part tile kernels
# ---------------------------------------------------------------------------


def _span(h_pad: int) -> int:
    """Output-window height of per-part chunk plans: the padded tile height,
    8-row aligned and capped at the single-device ROW_SPAN."""
    return max(8, min(ROW_SPAN, -(-h_pad // 8) * 8))


def kernel_chunk_arrays(mat: PartitionedMatrix,
                        chunk: Optional[int] = None) -> dict:
    """Host-side per-part chunk plans of a scalar-format partition.

    Counterpart of ``pallas_chunk_arrays``: one windowed
    :class:`~repro_torch.kernels.coo_spmv.ChunkPlan` per part (row-granular
    for CSR, element-granular for COO) against the common tile height
    ``h_pad``, stacked with a leading part axis by
    :func:`~repro_torch.kernels.coo_spmv.stack_chunk_plans`.  Runs once per
    compiled plan, never per request.

    Returns host tensors keyed ``chunk_rowind`` / ``chunk_colind`` /
    ``chunk_values`` (P, n_chunks, E), ``chunk_window`` / ``chunk_count``
    (P, n_chunks) — the JAX package's arrays — and, for the CUDA kernel,
    ``chunk_window_start`` (P, n_windows + 1) and the piece table
    ``chunk_pieces`` (P, Q, 4) / ``chunk_splits`` (P, Z, 3)
    (:func:`~repro_torch.kernels.coo_spmv.plan_pieces`).

    Raises:
      ValueError: for a block-format partition.
    """
    if mat.fmt not in ("coo", "csr"):
        raise ValueError("chunk plans are for scalar formats; block formats "
                         "run bcoo_spmv on the partition arrays")
    chunk = CHUNK_E if chunk is None else chunk
    span = _span(mat.h_pad)
    rowind, colind = mat.rowind.cpu(), mat.colind.cpu()
    values, nnz = mat.values.cpu(), mat.nnz.tolist()
    plans = [plan_chunks(rowind[p, :n], colind[p, :n], values[p, :n],
                         mat.h_pad, chunk=chunk, span=span,
                         row_granular=(mat.fmt == "csr"))
             for p, n in enumerate(nnz)]
    stacked = stack_chunk_plans(plans)
    return {f"chunk_{k}": v for k, v in stacked.items()
            if isinstance(v, torch.Tensor)}


def kernel_block_arrays(mat: PartitionedMatrix) -> dict:
    """Host-side per-part block-row pointers of a block-format partition:
    ``browptr`` (P, h_pad / r + 1), built once from each part's
    block-row-sorted ``rowind[:nnz]``."""
    if mat.fmt not in ("bcoo", "bcsr"):
        raise ValueError("block-row pointers are for block formats")
    n_brows = mat.h_pad // mat.block[0]
    return {"browptr": block_row_ptr(mat.rowind.cpu(), mat.nnz.tolist(),
                                     n_brows)}


class LocalKernel:
    """The per-part tile kernel of one partition, for all P parts at once
    (the reference's ``_local_kernel``).

    ``impl="torch"`` runs the oracles of kernels/ref.py part by part (the
    JAX package's ``impl="xla"``).  ``impl="cuda"`` launches the CUDA kernel
    once for every part — the windowed COO kernel on the stacked chunk plan
    (``chunk_*`` arrays) for COO/CSR, the block kernel on the per-part
    pointers (``browptr``) for BCOO/BCSR; on CPU tensors their plain
    versions run.  Part p reads ``windows.local(x, p)`` (default: the whole
    x).  ``__call__`` returns y (P, h_pad[, B]) in the values dtype, as the
    merges expect; :meth:`raw` and :meth:`plain` return the kernel's and the
    plain versions' output in the accumulation dtype.
    """

    def __init__(self, mat: PartitionedMatrix, impl: str,
                 windows: Optional[_build.XWindows] = None):
        if impl not in ("torch", "cuda"):
            raise ValueError(f"unknown impl {impl!r}: 'torch' or 'cuda'")
        self.mat = mat
        self.impl = impl
        self.windows = windows
        self.scalar = mat.fmt in ("coo", "csr")
        if self.scalar:
            span = _span(mat.h_pad)
            self.span, self.n_windows = span, max(1, -(-mat.h_pad // span))

    def _x(self, x: torch.Tensor, p: int) -> torch.Tensor:
        return x if self.windows is None else self.windows.local(x, p)

    def _plan(self, arrs: dict) -> ChunkPlan:
        return ChunkPlan(
            rowind=arrs["chunk_rowind"], colind=arrs["chunk_colind"],
            values=arrs["chunk_values"], window=arrs["chunk_window"],
            count=arrs["chunk_count"], n_windows=self.n_windows,
            out_rows=self.mat.h_pad, span=self.span,
            window_start=arrs["chunk_window_start"], pieces=arrs["chunk_pieces"],
            splits=arrs["chunk_splits"])

    def raw(self, arrs: dict, x: torch.Tensor) -> torch.Tensor:
        """impl="cuda": one part-axis launch (accumulation dtype)."""
        if self.scalar:
            return coo_spmv(self._plan(arrs), x, windows=self.windows)
        return bcoo_spmv(arrs["rowind"], arrs["colind"], arrs["values"], x,
                         self.mat.h_pad, arrs["nnz"], browptr=arrs["browptr"],
                         windows=self.windows)

    def plain(self, arrs: dict, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain versions, part by part (accumulation dtype)."""
        if self.scalar:
            return coo_spmv_plain(self._plan(arrs), x, self.windows)
        return bcoo_spmv_plain(arrs["rowind"], arrs["colind"], arrs["values"],
                               x, self.mat.h_pad, arrs["nnz"], self.windows)

    def __call__(self, arrs: dict, x: torch.Tensor) -> torch.Tensor:
        dtype = self.mat.dtype
        if self.impl == "cuda":
            y = self.raw(arrs, x)
            return y.to(dtype) if y.dtype != dtype else y
        oracle = kref.coo_spmv_ref if self.scalar else kref.bcoo_spmv_ref
        return torch.stack([
            oracle(arrs["rowind"][p], arrs["colind"][p], arrs["values"][p],
                   self._x(x, p), self.mat.h_pad, arrs["nnz"][p])
            for p in range(self.mat.n_parts)])


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _arrays(mat: PartitionedMatrix) -> dict:
    return dict(rowind=mat.rowind, colind=mat.colind, values=mat.values,
                nnz=mat.nnz, row_start=mat.row_start, col_start=mat.col_start)


def place_1d(mat: PartitionedMatrix, mesh,
             extra: Optional[dict] = None) -> dict:
    """Place a 1D partition's arrays (part axis leading) on the mesh's
    device.  ``extra`` merges more part-leading host arrays (the kernel's
    ``chunk_*`` plans or ``browptr``)."""
    arrs = _arrays(mat)
    if extra:
        arrs.update(extra)
    return {k: v.to(mesh.device) for k, v in arrs.items()}


def place_2d(mat: PartitionedMatrix, mesh,
             extra: Optional[dict] = None) -> dict:
    """Reshape parts (P,) -> (R, C) and place them on the mesh's device
    (``extra`` as in :func:`place_1d`)."""
    R, C = mat.grid
    arrs = place_1d(mat, mesh, extra)
    return {k: v.reshape((R, C) + tuple(v.shape[1:])) for k, v in arrs.items()}


def _flat(arrs: dict) -> dict:
    """(R, C, ...) placed arrays -> (P, ...) views."""
    return {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
            for k, v in arrs.items()}


# ---------------------------------------------------------------------------
# 1D execution (paper §6.1)
# ---------------------------------------------------------------------------


def _boundary_meta(mat: PartitionedMatrix):
    """Host-side boundary ownership for element-granular splits (paper
    §3.3.1: a row split between two neighbouring parts needs one partial
    sum moved)."""
    rs = mat.row_start.cpu().numpy().astype(np.int64)
    re_ = rs + mat.row_extent.cpu().numpy()
    Pn = mat.n_parts
    head_shared = np.zeros(Pn, bool)
    head_shared[1:] = rs[1:] < re_[:-1]  # my first row already started upstream
    recv_pos = np.zeros(Pn, np.int64)
    recv_pos[:-1] = np.clip(rs[1:] - rs[:-1], 0, mat.h_pad - 1)
    next_shared = np.zeros(Pn, bool)
    next_shared[:-1] = head_shared[1:]
    return head_shared, next_shared, recv_pos


class _BoundaryFix:
    """The 1D element-granular merge: part p hands its first row to part
    p - 1 when that row started there (the reference's ppermute)."""

    def __init__(self, mat: PartitionedMatrix, device):
        hs, ns, rp = _boundary_meta(mat)
        self.hs = torch.from_numpy(hs).to(device)
        self.ns = torch.from_numpy(ns).to(device)
        self.rp = torch.from_numpy(rp).to(device)
        self.parts = torch.arange(mat.n_parts, device=device)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """Fix y (P, h_pad[, B]) in place; returns it."""
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        tail = (1,) * (y.ndim - 2)
        hs = self.hs.reshape((-1,) + tail)
        send = torch.where(hs, y[:, 0], zero)
        recv = torch.zeros_like(send)
        recv[:-1] = send[1:]  # part i sends to part i - 1
        y[:, 0] = torch.where(hs, zero, y[:, 0])
        add = torch.where(self.ns.reshape((-1,) + tail), recv, zero)
        y[self.parts, self.rp] = y[self.parts, self.rp] + add
        return y


def _meta(mat: PartitionedMatrix) -> dict:
    return dict(row_start=mat.row_start.cpu().numpy(),
                row_extent=mat.row_extent.cpu().numpy(), rows=mat.shape[0])


class PartitionedProgram:
    """A built partitioned SpMV: ``prog(arrs, x) -> SpmvOutput``.

    The builders (:func:`spmv_1d`, :func:`spmv_1d_ring`, :func:`spmv_2d`)
    take the reference's arguments minus the mesh axis names: every part
    lies on ``mesh.device``, so no axis is ever addressed.

    ``arrs`` are the placed arrays (:func:`place_1d` / :func:`place_2d`), x
    the placed x, padded as the plan's ``_x_pad`` says.  ``local`` is the
    per-part tile kernel (None for the ring, which runs its own loop) and
    :meth:`x_buffer` the x the parts read their windows of.
    """

    def __init__(self, mat: PartitionedMatrix, local, merge: str):
        self.mat = mat
        self.local = local
        self.merge = merge
        self.meta = _meta(mat)

    def x_buffer(self, x: torch.Tensor) -> torch.Tensor:
        return x  # 1D: the all-gathered x; every part reads all of it

    def __call__(self, arrs: dict, x: torch.Tensor) -> SpmvOutput:
        raise NotImplementedError


class _Program1D(PartitionedProgram):
    def __init__(self, mat, local, fix):
        super().__init__(mat, local, "none")
        self.fix = fix

    def __call__(self, arrs, x):
        y = self.local(arrs, x)  # (P, h_pad[, B])
        if self.fix is not None:
            y = self.fix(y)
        return SpmvOutput(y, **self.meta)


def spmv_1d(mat: PartitionedMatrix, mesh,
            impl: str = "torch") -> PartitionedProgram:
    """Build the 1D partitioned SpMV: ``(placed_arrays, x) -> SpmvOutput``.

    x is the whole vector padded to a multiple of P (the all-gathered x).
    Row-granular balances need no merge; element-granular ``1d.nnz`` moves
    each split row's partial to the part where the row starts.  ``impl``
    selects the per-part tile kernel; impl="cuda" on scalar formats needs
    the ``chunk_*`` arrays placed (``extra=kernel_chunk_arrays(mat)``), on
    block formats the ``browptr`` ones (``kernel_block_arrays``).
    """
    needs_merge = mat.scheme == "1d.nnz" and mat.n_parts > 1
    fix = _BoundaryFix(mat, mesh.device) if needs_merge else None
    return _Program1D(mat, LocalKernel(mat, impl), fix)


# ---------------------------------------------------------------------------
# 1D ring execution (beyond-paper overlap schedule of the JAX package)
# ---------------------------------------------------------------------------


def bucket_by_source_shard(mat: PartitionedMatrix, n_shards: int
                           ) -> Tuple[PartitionedMatrix, np.ndarray]:
    """Re-lay each part's nonzeros as equal-capacity per-source-shard buckets.

    The JAX package's function, array for array: bucket s of part p holds
    the part's nonzeros whose columns lie in x shard s (width
    ceil(cols / n_shards)), at ``[s * cap_b, (s + 1) * cap_b)``, with
    ``cap_b`` the largest bucket.  Returns the re-laid PartitionedMatrix
    (scheme ``+ring``) and the counts (P, n_shards).
    """
    cols = mat.shape[1]
    shard_w = -(-cols // n_shards)
    rowind = mat.rowind.cpu().numpy()
    colind = mat.colind.cpu().numpy()
    values = mat.values.cpu()
    nnz = mat.nnz.tolist()
    Pn = rowind.shape[0]
    counts = np.zeros((Pn, n_shards), np.int32)
    per = []
    for p in range(Pn):
        n = int(nnz[p])
        src = colind[p, :n] // shard_w
        order = np.argsort(src, kind="stable")
        counts[p] = np.bincount(src, minlength=n_shards)
        per.append((rowind[p, :n][order], colind[p, :n][order],
                    values[p, :n][torch.from_numpy(order)]))
    cap_b = max(1, int(counts.max()))
    ri = np.zeros((Pn, n_shards * cap_b), np.int32)
    ci = np.zeros((Pn, n_shards * cap_b), np.int32)
    vv = torch.zeros((Pn, n_shards * cap_b), dtype=values.dtype)
    for p in range(Pn):
        offs = np.concatenate([[0], np.cumsum(counts[p])])
        for s in range(n_shards):
            lo, hi = int(offs[s]), int(offs[s + 1])
            dst = s * cap_b
            ri[p, dst: dst + hi - lo] = per[p][0][lo:hi]
            ci[p, dst: dst + hi - lo] = per[p][1][lo:hi]
            vv[p, dst: dst + hi - lo] = per[p][2][lo:hi]
    new = dataclasses.replace(
        mat, rowind=torch.from_numpy(ri), colind=torch.from_numpy(ci),
        values=vv, scheme=mat.scheme + "+ring")
    return new, counts


class _ProgramRing(PartitionedProgram):
    def __init__(self, mat, counts, fix):
        super().__init__(mat, None, "none")
        self.fix = fix
        self.counts = counts  # host (P, n_shards)
        Pn = mat.n_parts
        self.shard_w = -(-mat.shape[1] // Pn)
        self.cap_b = mat.capacity // Pn  # bucket_by_source_shard layout

    def __call__(self, arrs, x):
        mat, Pn, cap_b, shard_w = self.mat, self.mat.n_parts, self.cap_b, \
            self.shard_w
        acc = kref.acc_dtype(mat.dtype)
        shards = x.reshape((Pn, shard_w) + _tail(x))
        tail = (1,) * (x.ndim - 1)
        ys = []
        for me in range(Pn):
            y = torch.zeros((mat.h_pad,) + _tail(x), dtype=acc, device=x.device)
            for s in range(Pn):  # ring step s: shard (me + s) % P is held
                holder = (me + s) % Pn
                lo = holder * cap_b
                br = arrs["rowind"][me, lo: lo + cap_b].long()
                bc = arrs["colind"][me, lo: lo + cap_b].long()
                bv = arrs["values"][me, lo: lo + cap_b].to(acc)
                valid = torch.arange(cap_b, device=x.device) < \
                    int(self.counts[me, holder])
                local_col = (bc - holder * shard_w).clamp(0, shard_w - 1)
                prod = bv.reshape((cap_b,) + tail) * shards[holder][local_col].to(acc)
                prod = torch.where(valid.reshape((cap_b,) + tail), prod,
                                   torch.zeros((), dtype=acc, device=x.device))
                y.index_add_(0, br, prod)
            ys.append(y.to(mat.dtype) if acc != mat.dtype else y)
        y = torch.stack(ys)
        if self.fix is not None:
            y = self.fix(y)
        return SpmvOutput(y, **self.meta)


def spmv_1d_ring(mat: PartitionedMatrix, bucket_counts: np.ndarray,
                 mesh) -> PartitionedProgram:
    """Ring-scheduled 1D SpMV over a :func:`bucket_by_source_shard` layout.

    At ring step s part p multiplies only its bucket of the x shard it
    holds, ``(p + s) % P``, then passes the shard on; on one device the
    shards are views of x.  Runs the torch local kernel only, as the
    reference runs only ``impl="xla"``.
    """
    needs_merge = mat.scheme.startswith("1d.nnz") and mat.n_parts > 1
    fix = _BoundaryFix(mat, mesh.device) if needs_merge else None
    return _ProgramRing(mat, np.asarray(bucket_counts), fix)


# ---------------------------------------------------------------------------
# 2D execution (paper §6.2)
# ---------------------------------------------------------------------------


def _sum_cols(y: torch.Tensor) -> torch.Tensor:
    """(R, C, ...) -> (R, ...): the psum over the column axis, column by
    column in the values dtype."""
    acc = y[:, 0]
    for c in range(1, y.shape[1]):
        acc = acc + y[:, c]
    return acc


class _Program2D(PartitionedProgram):
    def __init__(self, mat, local, merge, shard_w, rows_pad):
        super().__init__(mat, local, merge)
        self.shard_w, self.rows_pad = shard_w, rows_pad
        self.row_start = mat.row_start.tolist()

    def x_buffer(self, x):
        mat = self.mat
        if mat.scheme == "2d.variable-sized":
            # all-gather, then every part slices its own column range
            pad = torch.zeros((mat.w_pad,) + _tail(x), dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, pad])
        C = mat.grid[1]
        if self.shard_w == mat.w_pad:
            return x  # the column shard IS the tile's x slice
        # the shard of tile column c, zero-padded to the tile width
        xs = x.reshape((C, self.shard_w) + _tail(x))
        pad = torch.zeros((C, mat.w_pad - self.shard_w) + _tail(x),
                          dtype=x.dtype, device=x.device)
        return torch.cat([xs, pad], 1).reshape((C * mat.w_pad,) + _tail(x))

    def __call__(self, arrs, x):
        mat = self.mat
        R, C = mat.grid
        y = self.local(_flat(arrs), self.x_buffer(x))  # (P, h_pad[, B])
        tail = tuple(y.shape[2:])
        if self.merge == "psum":
            y = _sum_cols(y.reshape((R, C, mat.h_pad) + tail))
            return SpmvOutput(y[:, None].expand((R, C, mat.h_pad) + tail),
                              merge="psum", **self.meta)
        if self.merge == "psum_scatter":
            y = _sum_cols(y.reshape((R, C, mat.h_pad) + tail))
            return SpmvOutput(y.reshape((R, C, mat.h_pad // C) + tail),
                              merge="psum_scatter", **self.meta)
        # "global": every part's rows land in one buffer at row_start (h_pad
        # of overhang so the last tiles never clamp), summed in part order
        buf = torch.zeros((self.rows_pad + mat.h_pad,) + tail, dtype=y.dtype,
                          device=y.device)
        for p, r0 in enumerate(self.row_start):
            buf[r0: r0 + mat.h_pad] += y[p]
        return SpmvOutput(buf[None, None], merge="global",
                          replicated_global=buf[: mat.shape[0]], **self.meta)


def spmv_2d(mat: PartitionedMatrix, mesh, merge: Optional[str] = None,
            impl: str = "torch") -> PartitionedProgram:
    """Build the 2D partitioned SpMV: ``(placed_arrays, x) -> SpmvOutput``.

    merge:
      * "psum"         (equally-sized default): sum the partials of each
                        grid row over its C columns.
      * "psum_scatter" : the same sum, each part keeping 1/C of the rows.
      * "global"       (equally-wide / variable-sized): every part's rows
                        scattered into one global buffer and summed — the
                        paper's retrieve + merge path (Obs. 12).

    Part (r, c) reads its column window of x: the c-th of C equal shards
    (equally-sized / -wide), zero-padded to the tile width, or its own
    column range of the whole x (variable-sized).  ``impl`` as in
    :func:`spmv_1d`.

    Raises:
      ValueError: a psum merge on unaligned rows, or a grid the scheme's
        alignment rules do not allow.
    """
    R, C = mat.grid
    scheme = mat.scheme.split(".", 1)[1]
    if merge is None:
        merge = "psum" if scheme == "equally-sized" else "global"
    aligned = scheme == "equally-sized"
    if merge in ("psum", "psum_scatter") and not aligned:
        raise ValueError(f"{merge} merge requires aligned rows (equally-sized)")
    if merge == "psum_scatter" and mat.h_pad % C:
        raise ValueError(f"psum_scatter needs h_pad % C == 0 (got "
                         f"{mat.h_pad} % {C})")
    if merge not in ("psum", "psum_scatter", "global"):
        raise ValueError(f"unknown merge {merge!r}")
    if scheme != "variable-sized" and mat.shape[1] % C != 0:
        raise ValueError(
            f"{scheme} needs cols % C == 0 to align x shards with tiles "
            f"(got {mat.shape[1]} % {C})")
    if aligned and mat.shape[0] % R != 0:
        raise ValueError("equally-sized needs rows % R == 0")
    rows_pad = mat.h_pad * R if aligned else -(-mat.shape[0] // 8) * 8
    cols = mat.shape[1]
    if scheme == "variable-sized":
        shard_w = -(-cols // C)
        offsets = mat.col_start.tolist()
    else:
        shard_w = cols // C
        width = mat.w_pad if shard_w != mat.w_pad else shard_w
        offsets = [(p % C) * width for p in range(R * C)]
    windows = _build.XWindows.build(offsets, mat.w_pad, mesh.device)
    return _Program2D(mat, LocalKernel(mat, impl, windows), merge, shard_w,
                      rows_pad)


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------


def assemble_rows(out: SpmvOutput) -> torch.Tensor:
    """Assemble the global y (rows[, B]) from per-part slices, on their
    device, in the JAX package's order.

    1D (merge="none"): add each part's slice into its row range, part by
    part (shared boundary rows were moved to their owner, so the
    duplicates are zero).  2D psum: take column 0 of each grid row.  2D
    psum_scatter: part (r, c) holds segment c of grid row r.  2D global:
    already replicated.
    """
    if out.replicated_global is not None:
        return out.replicated_global
    yp = out.y_parts
    if out.merge in ("psum", "psum_scatter"):
        R, C = yp.shape[:2]
        y = torch.zeros((out.rows,) + tuple(yp.shape[3:]), dtype=yp.dtype,
                        device=yp.device)
        for r in range(R):
            r0 = int(out.row_start[r * C])
            ext = min(int(out.row_extent[r * C]), out.rows - r0)
            block = (yp[r, 0] if out.merge == "psum"
                     else yp[r].reshape((-1,) + tuple(yp.shape[3:])))
            y[r0: r0 + ext] = block[:ext]
        return y
    y = torch.zeros((out.rows,) + tuple(yp.shape[2:]), dtype=yp.dtype,
                    device=yp.device)
    for p in range(yp.shape[0]):
        r0 = int(out.row_start[p])
        ext = min(int(out.row_extent[p]), out.rows - r0)
        y[r0: r0 + ext] += yp[p][:ext]
    return y
