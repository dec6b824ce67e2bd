"""The JAX package's collectives over the process groups of a process mesh.

Counterpart of the ``jax.lax`` collectives that ``repro/core/distributed.py``
runs under ``shard_map``, with their semantics, on a
:class:`~repro_torch.core.mesh.ProcessMesh`:

  JAX (per device)                   | here (per rank)
  -----------------------------------+-----------------------------------
  all_gather(x, axis, tiled=True)    | :meth:`Collectives.all_gather`
  ppermute(x, axis, perm)            | :meth:`Collectives.ppermute` (a rank
                                     | that is no destination gets zeros)
  psum(x, axis) / psum(x, all axes)  | :meth:`Collectives.psum`
  psum_scatter(x, axis, tiled=True)  | :meth:`Collectives.psum_scatter`

Every sum is taken over tensors of the values dtype and comes back in it:
the callers cast each part to the values dtype first
(``core/distributed.py``), so bfloat16 partials are summed as bfloat16 and
int8 as int8 (wrapping), as in the reference.  The order in which the
backend adds the ranks' values, and whether it widens them on the way, is
the backend's: a sum that is not exact may differ in its last bit from the
one-device program's column-by-column sum (integer-valued data agree bit
for bit).  ``perm`` pairs and the
tiled order are positions along the axis, which are the group's ranks in
order (rank ``p`` sits at flat place ``p`` of the grid).

Over gloo, CUDA tensors are staged through pinned host buffers here and
nowhere else (gloo on the GPU lacks most collectives): the transport the
records call ``gloo-host-staged``.  Over NCCL the tensors stay on the card.

Each call adds to this object's counts, by kind (the names of the
reference's ``collective_bytes``, ``repro/analysis/roofline.py:78``): its
calls, its bytes and its seconds.  Bytes are counted as the reference
counts them in compiled HLO: the bytes of the collective's result on this
rank (an all-gather's whole gathered tensor, a reduce-scatter's shard).
A collective over one rank is the identity: it still runs through the
backend (so a world of one exercises it) but counts nothing, as XLA
removes it.  Seconds are host seconds from the call to its
result being on this rank's device (each call waits on the current stream
at its end); the ring's overlapped permutes count only the wait.
"""
from __future__ import annotations

import time
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .streams import wait

__all__ = ["Collectives", "CountingCollectives", "collectives_for", "KINDS"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute")
Axes = Union[str, Tuple[str, ...]]


class _Pending:
    """A started :meth:`Collectives.start_ppermute`; :meth:`wait` returns
    the received tensor on the device."""

    def __init__(self, coll, reqs, out, device):
        self.coll, self.reqs, self.out, self.device = coll, reqs, out, device

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for r in self.reqs:
            r.wait()
        out = self.coll._unstage(self.out, self.device)
        self.coll._done("collective-permute", t0)
        return out


class Collectives:
    """The collectives of one :class:`~repro_torch.core.mesh.ProcessMesh`,
    with per-kind counts of calls, bytes and seconds (:meth:`reset`,
    :meth:`snapshot`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.staged = mesh.world.transport == "gloo-host-staged"
        self.reset()

    # -- counts ------------------------------------------------------------

    def reset(self) -> None:
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}
        self.seconds = {k: 0.0 for k in KINDS}

    def snapshot(self) -> dict:
        """``{"calls", "bytes", "seconds"}``, each by kind, plus ``total``
        bytes."""
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds),
                "total_bytes": sum(self.bytes.values())}

    def _count(self, kind: str, result: torch.Tensor, n: int) -> None:
        if n > 1:  # over one rank the op is the identity (XLA drops it)
            self.calls[kind] += 1
            self.bytes[kind] += result.numel() * result.element_size()

    def _done(self, kind: str, t0: float) -> None:
        self.seconds[kind] += time.perf_counter() - t0

    # -- groups and staging --------------------------------------------------

    def _group(self, axes: Axes):
        """(process group, its size) of one axis, or of the whole mesh for
        a tuple of every axis name."""
        names = self.mesh.axis_names
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        if len(axes) == 1:
            i = names.index(axes[0])
            return self.mesh.groups[i], self.mesh.devices.shape[i]
        if sorted(axes) != sorted(names):
            raise ValueError(f"collectives over {axes} on a mesh of {names}: "
                             "one axis or all of them")
        return self.mesh.world_group, self.mesh.devices.size

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend reads it: a pinned host copy for gloo
        with CUDA tensors (complete when this returns), else ``x``."""
        x = x.contiguous()
        if not self.staged or x.device.type != "cuda":
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        wait(x.device)
        return h

    def _buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self.staged and like.device.type == "cuda":
            return torch.zeros(shape, dtype=like.dtype, pin_memory=True)
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    def _unstage(self, out: torch.Tensor, device: torch.device) -> torch.Tensor:
        if out.device != device:
            out = out.to(device, non_blocking=True)
        wait(device)
        return out

    # -- the transport (torch.distributed) -----------------------------------

    def _all_gather(self, out, src, group) -> None:
        dist.all_gather_into_tensor(out, src, group=group)

    def _all_reduce(self, buf, group) -> None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)

    def _reduce_scatter(self, out, src, group) -> None:
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)

    def _p2p(self, ops) -> list:
        return dist.batch_isend_irecv([dist.P2POp(*op) for op in ops])

    # -- the collectives -----------------------------------------------------

    def all_gather(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``all_gather(x, axes, tiled=True)``: the ranks' x concatenated
        along dim 0 in axis order."""
        group, n = self._group(axes)
        t0 = time.perf_counter()
        src = self._stage(x)
        out = self._buffer((n * x.shape[0],) + tuple(x.shape[1:]), x)
        self._all_gather(out, src, group)
        self._count("all-gather", out, n)
        out = self._unstage(out, x.device)
        self._done("all-gather", t0)
        return out

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``psum(x, axes)``: the ranks' x summed elementwise, in x's dtype,
        on every rank of the group."""
        group, n = self._group(axes)
        t0 = time.perf_counter()
        buf = self._stage(x)
        buf = x.clone() if buf is x else buf  # all_reduce writes in place
        self._all_reduce(buf, group)
        self._count("all-reduce", buf, n)
        out = self._unstage(buf, x.device)
        self._done("all-reduce", t0)
        return out

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``psum_scatter(x, axis, tiled=True)``: the sum over the axis,
        rank ``c`` keeping rows ``[c * h / n, (c + 1) * h / n)``."""
        group, n = self._group(axis)
        if x.shape[0] % n:
            raise ValueError(f"psum_scatter of {x.shape[0]} rows over {n} ranks")
        t0 = time.perf_counter()
        src = self._stage(x)
        out = self._buffer((x.shape[0] // n,) + tuple(x.shape[1:]), x)
        self._reduce_scatter(out, src, group)
        self._count("reduce-scatter", out, n)
        out = self._unstage(out, x.device)
        self._done("reduce-scatter", t0)
        return out

    def _peer(self, axis: str, pos: int) -> int:
        """The global rank at ``pos`` along ``axis``, this rank's other
        coordinates kept."""
        coords = list(self.mesh.coords)
        coords[self.mesh.axis_names.index(axis)] = pos
        return int(np.ravel_multi_index(coords, self.mesh.devices.shape))

    def start_ppermute(self, x: torch.Tensor, axis: str,
                       perm: Sequence[Tuple[int, int]]) -> _Pending:
        """Start ``ppermute(x, axis, perm)``; the result's ``wait()`` gives
        what this rank received (zeros where it is no destination).  Work
        enqueued on the device meanwhile overlaps the transfer."""
        t0 = time.perf_counter()
        _, n = self._group(axis)
        me = self.mesh.coords[self.mesh.axis_names.index(axis)]
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(dsts) > 1 or len(srcs) > 1:
            raise ValueError(f"perm {perm} sends or receives twice at {me}")
        out = self._buffer(tuple(x.shape), x)
        ops = []
        if dsts and dsts[0] == me:  # to itself: a copy, no transfer
            out.copy_(x)
        else:
            if dsts:
                ops.append((dist.isend, self._stage(x),
                            self._peer(axis, dsts[0])))
            if srcs:
                ops.append((dist.irecv, out, self._peer(axis, srcs[0])))
        if perm:
            self._count("collective-permute", x, n)
        reqs = self._p2p(ops) if ops else []
        self._done("collective-permute", t0)
        return _Pending(self, reqs, out, x.device)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``ppermute(x, axis, perm)``: rank at position ``s`` sends x to
        position ``d`` for each ``(s, d)`` of ``perm``; a rank that is no
        destination receives zeros."""
        return self.start_ppermute(x, axis, perm).wait()


class CountingCollectives(Collectives):
    """The collectives of a dry-run mesh
    (:func:`repro_torch.core.mesh.dry_process_mesh`): every call counts
    what :class:`Collectives` counts and returns a result of the right
    shape and dtype (zeros where data would arrive), moving nothing.  The
    SpMV dry run (``launch/dryrun_spmv.py``) counts one rank of a mesh of
    hundreds this way, on fake tensors."""

    def _all_gather(self, out, src, group) -> None:
        pass

    def _all_reduce(self, buf, group) -> None:
        pass

    def _reduce_scatter(self, out, src, group) -> None:
        pass

    def _p2p(self, ops) -> list:
        return []


def collectives_for(mesh) -> Collectives:
    """The collectives of a process mesh: real ones over its world, or
    counting ones on a dry-run mesh."""
    cls = CountingCollectives if mesh.world.backend == "dry" else Collectives
    return cls(mesh)
