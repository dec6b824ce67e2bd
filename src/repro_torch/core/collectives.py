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
  all_to_all(x, axis, split_axis,    | :meth:`Collectives.all_to_all`
             concat_axis, tiled=True)|

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
Where every rank of a gloo world runs on one x86 host, the data skips
gloo's sockets and moves through a shared memory mapping of each process
group (:class:`SharedMemoryCollectives`, ``shm-host-staged``; ``shm`` for
CPU tensors): a gloo collective over loopback sockets has taken
milliseconds whatever its size (PERF.md), a round through shared memory
costs a copy and a spin.  CUDA tensors are copied straight between the
card and the mapping (page-locked for the card's copy engines where the
driver allows it), and sums are taken on the card.
:func:`collectives_for` makes that choice from what the mesh records;
nobody sets it.

Each call adds to this object's counts, by kind (the names of the
reference's ``collective_bytes``, ``repro/analysis/roofline.py:78``): its
calls, its bytes and its seconds.  Bytes are counted as the reference
counts them in compiled HLO: the bytes of the collective's result on this
rank (an all-gather's whole gathered tensor, a reduce-scatter's shard).
A collective over one rank is the identity: it still runs through the
backend (so a world of one exercises it) but counts nothing, as XLA
removes it.  Seconds are host seconds from the call to its
result being on this rank's device (each call waits on the current stream
at its end; over ``gloo-host-staged`` and ``shm-host-staged``, until the
copies back to the card are enqueued on the current stream, ahead of every
later use of the result);
the ring's overlapped permutes count only the wait.

Under autograd (a tensor that requires grad, with grad enabled) ``psum``,
``psum_scatter`` and ``all_to_all`` are differentiable, each with the
transpose GSPMD gives it: a psum's gradient passes through unchanged (its
consumers hold the whole gradient on every rank), a psum-scatter's is
all-gathered, an all-to-all's goes back by the reverse all-to-all.  The
backward's collectives run through the same object and add to its counts.
An all-gather's transpose depends on what its consumers hold
(``core/sharding.py``: ``gather_dim``), so ``all_gather`` here is the plain
move.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import platform
import socket
import time
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .streams import wait

__all__ = ["Collectives", "CountingCollectives", "SharedMemoryCollectives",
           "collectives_for", "KINDS"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
Axes = Union[str, Tuple[str, ...]]


def _host_wait(device: torch.device) -> None:
    """Block until the current stream of ``device`` has done its work so
    far, yielding the CPU while it waits (a blocking-sync event): ranks
    that share one card also share its host, and spinning waits starve the
    gloo threads that carry the staged data."""
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(device))
    event.synchronize()


class _Pending:
    """A started :meth:`Collectives.start_ppermute`; :meth:`wait` returns
    the received tensor on the device."""

    def __init__(self, coll, reqs, out, device):
        self.coll, self.reqs, self.out, self.device = coll, reqs, out, device

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for r in self.reqs:
            r.wait()
        # staged as the backend needs, as start_ppermute staged it
        out = Collectives._unstage(self.coll, self.out, self.device)
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

    @property
    def transport(self) -> str:
        """How the data moves: the world's transport (``"nccl"``,
        ``"gloo"``, ``"gloo-host-staged"``)."""
        return self.mesh.world.transport

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
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.bytes[kind] = (self.bytes.get(kind, 0)
                                + result.numel() * result.element_size())

    def _done(self, kind: str, t0: float) -> None:
        self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0

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
        _host_wait(x.device)
        return h

    def _buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self.staged and like.device.type == "cuda":
            return torch.zeros(shape, dtype=like.dtype, pin_memory=True)
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    def _unstage(self, out: torch.Tensor, device: torch.device) -> torch.Tensor:
        if out.device != device:  # host-staged: the copy back is enqueued on
            # the current stream, ahead of every later use of the result
            return out.to(device, non_blocking=True)
        wait(device)
        return out

    # -- the transport (torch.distributed) -----------------------------------

    def _all_gather(self, out, src, group) -> None:
        dist.all_gather_into_tensor(out, src, group=group)

    def _all_reduce(self, buf, group) -> None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)

    def _reduce_scatter(self, out, src, group) -> None:
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)

    def _all_to_all(self, out, src, group) -> None:
        dist.all_to_all_single(out, src, group=group)

    def _p2p(self, ops) -> list:
        return dist.batch_isend_irecv([dist.P2POp(*op) for op in ops])

    def _scatter(self, out, src, group) -> None:
        dist.scatter(out, src, src=0, group=group)

    # -- the collectives -----------------------------------------------------

    def scatter(self, pieces, shape, dtype) -> torch.Tensor:
        """Rank 0 of the mesh sends ``pieces[p]`` (host tensors of ``shape``
        and ``dtype``; None on the other ranks) to rank ``p``, and every
        rank returns its piece on its device: the load step of an executor
        that rank 0 leads (``core/control.py``), the paper's Fig. 4 load,
        which JAX's sharded ``device_put`` does.  It has no ``jax.lax``
        counterpart and counts under a kind of its own, ``"scatter"``: the
        bytes this rank received."""
        group, n = self.mesh.world_group, self.mesh.devices.size
        device = self.mesh.device
        t0 = time.perf_counter()
        out = self._buffer(tuple(shape), torch.empty(0, dtype=dtype,
                                                     device=device))
        src = None
        if self.mesh.rank == 0:
            to = device if self.mesh.world.backend == "nccl" else "cpu"
            src = [p.to(to).contiguous() for p in pieces]
        self._scatter(out, src, group)
        self._count("scatter", out, n)
        out = self._unstage(out, device)
        self._done("scatter", t0)
        return out

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
        on every rank of the group.  Its gradient is the identity."""
        if _recording(x):
            return _Psum.apply(x, self, axes)
        return self._psum(x, axes)

    def _psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
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
        rank ``c`` keeping rows ``[c * h / n, (c + 1) * h / n)``.  Its
        gradient is all-gathered over the axis."""
        if _recording(x):
            return _PsumScatter.apply(x, self, axis)
        return self._psum_scatter(x, axis)

    def _psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
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

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int = 0,
                   concat_dim: int = 0) -> torch.Tensor:
        """``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: x
        split along ``split_dim`` into one block per rank of the axis, block
        ``k`` sent to position ``k``; the blocks received concatenated along
        ``concat_dim`` in position order.  Its gradient goes back by the
        reverse all-to-all."""
        if _recording(x):
            return _AllToAll.apply(x, self, axis, split_dim, concat_dim)
        return self._all_to_all_move(x, axis, split_dim, concat_dim)

    def _all_to_all_move(self, x: torch.Tensor, axis: str, split_dim: int,
                         concat_dim: int) -> torch.Tensor:
        group, n = self._group(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all of {x.shape[split_dim]} rows of dim "
                             f"{split_dim} over {n} ranks")
        t0 = time.perf_counter()
        blocks = x.movedim(split_dim, 0)
        rest = tuple(blocks.shape[1:])
        blocks = blocks.reshape((n, blocks.shape[0] // n) + rest)
        src = self._stage(blocks)
        out = self._buffer(tuple(src.shape), blocks)
        self._all_to_all(out, src, group)
        self._count("all-to-all", out, n)
        out = self._unstage(out, x.device)
        self._done("all-to-all", t0)
        # out[k] is position k's block: put the split dim back, then lay
        # the n blocks side by side along the concat dim
        out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return out.reshape(shape)

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
        # the permutes go over the backend, staged as it needs
        out = Collectives._buffer(self, tuple(x.shape), x)
        ops = []
        if dsts and dsts[0] == me:  # to itself: a copy, no transfer
            out.copy_(x)
        else:
            if dsts:
                ops.append((dist.isend, Collectives._stage(self, x),
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


def _recording(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, axes):
        return coll._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, axis):
        ctx.coll, ctx.axis = coll, axis
        return coll._psum_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_gather(g, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, axis, split_dim, concat_dim):
        ctx.args = (coll, axis, split_dim, concat_dim)
        return coll._all_to_all_move(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        coll, axis, split_dim, concat_dim = ctx.args
        return (coll._all_to_all_move(g, axis, concat_dim, split_dim),
                None, None, None, None)


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

    def _all_to_all(self, out, src, group) -> None:
        pass

    def _p2p(self, ops) -> list:
        return []

    def _scatter(self, out, src, group) -> None:
        pass


# A rank publishes a round by storing its data and then its counter, and a
# reader that sees the counter reads the data after it, with no fence: sound
# where the processor keeps stores in order and loads in order (x86's TSO).
STORES_IN_ORDER = platform.machine().lower() in ("x86_64", "amd64")


def _driver():
    """The CUDA driver library (its calls leave the runtime's error state
    alone), or None."""
    try:
        return ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None


class _HostMapping:
    """A shared memory mapping of one process group's ranks on one host: a
    sequence counter per rank (one cache line each) and, for each of two
    parities, one slot of ``slot`` bytes per rank.  Made collectively: the
    group's first rank creates an anonymous memory file (``memfd_create``)
    and hands its descriptor to the others over a Unix socket in the
    abstract namespace; nothing is left on disk or in the file system."""

    def __init__(self, group, slot: int, timeout: float):
        assert STORES_IN_ORDER, (
            f"shared-memory rounds publish without a fence, which needs "
            f"x86's store order; this is {platform.machine()}")
        ranks = dist.get_process_group_ranks(group)
        self.n, self.pos = len(ranks), ranks.index(dist.get_rank())
        self.slot, self.timeout, self.k = slot, timeout, 0
        head = -(-64 * self.n // 4096) * 4096
        size = head + 2 * self.n * slot
        addr = [None]
        if self.pos == 0:
            fd = os.memfd_create("repro_torch_shm")
            os.ftruncate(fd, size)
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.settimeout(timeout)
            listener.bind(b"\0repro_torch_shm_" + os.urandom(8).hex().encode())
            listener.listen(self.n)
            addr[0] = listener.getsockname()
        dist.broadcast_object_list(addr, src=ranks[0], group=group)
        if self.pos == 0:
            with listener:
                for _ in range(self.n - 1):
                    conn, _ = listener.accept()
                    with conn:
                        socket.send_fds(conn, [b"m"], [fd])
        else:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
                conn.settimeout(timeout)
                conn.connect(addr[0])
                fd = socket.recv_fds(conn, 1, 1)[1][0]
        self.map = mmap.mmap(fd, size)
        os.close(fd)
        self.seq = np.frombuffer(self.map, dtype=np.int64, count=8 * self.n)[::8]
        self.data = torch.frombuffer(self.map, dtype=torch.uint8, offset=head,
                                     count=2 * self.n * slot)
        self.pinned = None  # the driver, once it has page-locked the slots
        self.pin_error = None  # its refusal's CUresult
        self.reads = None  # an event after the card's last reads of the slots

    def pin(self, device: torch.device) -> None:
        """Page-lock the slots for ``device``'s copy engines
        (``cuMemHostRegister``), so copies to and from the card move
        straight between it and the mapping; where the driver refuses
        (``pin_error``), the copies go through its own staging."""
        lib = _driver()
        if lib is None:
            self.pin_error = "no libcuda"
            return
        torch.cuda.set_device(device)  # its context current on this thread
        reg = getattr(lib, "cuMemHostRegister_v2", None) or lib.cuMemHostRegister
        reg.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint]
        err = reg(self.data.data_ptr(), self.data.numel(), 0)
        if err:
            self.pin_error = int(err)
        else:
            self.pinned = lib

    def __del__(self):
        if getattr(self, "pinned", None) is not None:
            self.pinned.cuMemHostUnregister.argtypes = [ctypes.c_void_p]
            self.pinned.cuMemHostUnregister(self.data.data_ptr())

    def read_on(self, device: torch.device) -> None:
        """Mark the copies from this round's views enqueued on ``device``'s
        current stream so far: the next round waits for them before it
        lets the others write those slots again."""
        if device.type == "cuda":
            self.reads = torch.cuda.Event(blocking=True)
            self.reads.record(torch.cuda.current_stream(device))

    def _slot(self, parity: int, pos: int) -> torch.Tensor:
        start = (parity * self.n + pos) * self.slot
        return self.data[start:start + self.slot]

    def round(self, mine: torch.Tensor, read: int | None = None) -> list:
        """Post ``mine`` (uint8, at most ``slot`` bytes, the same length on
        every rank; on the host or the card) and return every rank's, in
        group order: views of the mapping, valid until this rank's next
        round but one (``read`` bytes of each, where ranks post different
        lengths: a scatter's root posts, the others read).  Each rank
        writes its slot, then its counter; x86
        keeps stores in order, so a rank that sees a counter sees the data
        before it.  A copy from the card is complete before the counter is
        written, and so are the card's reads of the last round's views
        (:meth:`read_on`)."""
        self.k += 1
        parity, n_bytes = self.k & 1, mine.numel()
        if n_bytes:
            self._slot(parity, self.pos)[:n_bytes].copy_(mine, non_blocking=True)
        n_bytes = n_bytes if read is None else read  # what is read of each
        if mine.device.type == "cuda":
            _host_wait(mine.device)
        if self.reads is not None:  # the last round's slots are read: the
            self.reads.synchronize()  # others may write them once this posts
            self.reads = None
        self.seq[self.pos] = self.k
        deadline, spins = time.monotonic() + self.timeout, 0
        while not (self.seq >= self.k).all():
            spins += 1
            if spins % 1024 == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"shared-memory round {self.k}: a rank of "
                                       f"{self.n} did not post within "
                                       f"{self.timeout:.0f} s")
                os.sched_yield()
        return [self._slot(parity, p)[:n_bytes] for p in range(self.n)]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _fetch(views, device: torch.device) -> list:
    """``views`` (ranks' bytes in a mapping) where the sum is taken: on the
    host as they are, on the card copied into one buffer."""
    if device.type != "cuda":
        return views
    buf = torch.empty((len(views), views[0].numel()), dtype=torch.uint8,
                      device=device)
    for row, v in zip(buf, views):
        row.copy_(v, non_blocking=True)
    return list(buf)


class SharedMemoryCollectives(Collectives):
    """The collectives of a process mesh whose ranks share one host, with
    the data moving through a shared memory mapping of each group
    (:class:`_HostMapping`) instead of the backend's sockets: every rank
    posts its bytes and reads the others', round by round (messages longer
    than a slot take several).  CUDA tensors are copied from the card into
    the rank's slot and from the slots onto the card, with no staging
    buffer, and their sums are taken on the card; sums are taken in group
    order, the same on every rank.  The backend's groups still carry the
    setup and ``ppermute`` (host-staged, as over gloo).  Over gloo on a
    host whose thread wake-ups are slow, each gloo collective costs
    milliseconds; a round here costs a copy and a spin on the counters.
    A collective returns with its copies onto the card and its sums
    enqueued on the current stream; a rank's next round waits for them
    before it posts (the slots they read are the others' to write two
    rounds on)."""

    SLOT = 1 << 24  # bytes a rank posts in one round

    def __init__(self, mesh, slot: int | None = None,
                 timeout: float = 300.0):
        super().__init__(mesh)
        self.staged = mesh.world.device.type == "cuda"  # whatever the backend
        self.slot = self.SLOT if slot is None else int(slot)
        self.timeout = timeout

    @property
    def transport(self) -> str:
        return "shm-host-staged" if self.staged else "shm"

    @property
    def pinned(self):
        """Whether the card's copies move straight to and from the mappings
        made so far: True where the driver page-locked every one, else the
        first refusal's CUresult (None before any mapping)."""
        maps = list(self.mesh.host_mappings.values())
        if not maps:
            return None
        errors = [m.pin_error for m in maps if m.pinned is None]
        return errors[0] if errors else True

    def _map(self, group) -> _HostMapping:
        maps = self.mesh.host_mappings  # shared by the mesh's collectives
        if (group, self.slot) not in maps:
            m = maps[group, self.slot] = _HostMapping(group, self.slot, self.timeout)
            if self.staged:
                m.pin(self.mesh.device)
        return maps[group, self.slot]

    # the data stays where it is: the rounds copy it to and from the slots
    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous()

    def _buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _unstage(self, out: torch.Tensor, device: torch.device) -> torch.Tensor:
        return out  # its copies and sums are enqueued on the current stream

    def _rounds(self, src: torch.Tensor, group):
        """(offset, every rank's bytes) for each slot-sized piece of src's
        bytes; the card's reads of each piece's views are marked before
        the next piece."""
        m, data = self._map(group), _bytes(src)
        for off in range(0, data.numel(), self.slot):
            yield off, m.round(data[off:off + self.slot])
            m.read_on(src.device)

    def _all_gather(self, out, src, group) -> None:
        dst, size = _bytes(out), src.numel() * src.element_size()
        for off, views in self._rounds(src, group):
            for p, v in enumerate(views):
                dst[p * size + off:p * size + off + v.numel()].copy_(
                    v, non_blocking=True)

    def _sum_into(self, dst: torch.Tensor, views, dtype) -> None:
        views = _fetch(views, dst.device)
        acc = views[0].view(dtype).clone()
        for v in views[1:]:
            acc += v.view(dtype)
        dst.copy_(acc.view(torch.uint8))

    def _all_reduce(self, buf, group) -> None:
        dst = _bytes(buf)
        for off, views in self._rounds(buf, group):
            self._sum_into(dst[off:off + views[0].numel()], views, buf.dtype)

    def _reduce_scatter(self, out, src, group) -> None:
        dst, size = _bytes(out), out.numel() * out.element_size()
        pos = self._map(group).pos
        for off, views in self._rounds(src, group):
            lo = max(off, pos * size)
            hi = min(off + views[0].numel(), (pos + 1) * size)
            if lo < hi:
                self._sum_into(dst[lo - pos * size:hi - pos * size],
                               [v[lo - off:hi - off] for v in views], out.dtype)

    def _scatter(self, out, src, group) -> None:
        m, dst = self._map(group), _bytes(out)
        size = dst.numel()
        data = (torch.cat([_bytes(p) for p in src]) if src is not None
                else torch.empty(0, dtype=torch.uint8))
        for off in range(0, size * m.n, self.slot):
            n_read = min(self.slot, size * m.n - off)
            views = m.round(data[off:off + n_read], read=n_read)
            lo = max(off, m.pos * size)
            hi = min(off + n_read, (m.pos + 1) * size)
            if lo < hi:  # the root (position 0) posted; each reads its piece
                dst[lo - m.pos * size:hi - m.pos * size].copy_(
                    views[0][lo - off:hi - off], non_blocking=True)
            m.read_on(out.device)

    def _all_to_all(self, out, src, group) -> None:
        dst, block = _bytes(out), src[0].numel() * src.element_size()
        pos = self._map(group).pos
        for off, views in self._rounds(src, group):
            lo = max(off, pos * block)
            hi = min(off + views[0].numel(), (pos + 1) * block)
            if lo < hi:
                for q, v in enumerate(views):
                    start = q * block + lo - pos * block
                    dst[start:start + hi - lo].copy_(v[lo - off:hi - off],
                                                     non_blocking=True)


def collectives_for(mesh) -> Collectives:
    """The collectives of a process mesh: counting ones on a dry-run mesh;
    shared-memory ones for a gloo world whose ranks all run on one x86 host
    (``mesh.one_host``); else the backend's."""
    if mesh.world.backend == "dry":
        return CountingCollectives(mesh)
    if mesh.world.backend == "gloo" and mesh.one_host and STORES_IN_ORDER:
        return SharedMemoryCollectives(mesh, timeout=mesh.world.timeout)
    return Collectives(mesh)
