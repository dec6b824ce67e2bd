"""World — the process group that a process mesh runs on.

Counterpart of ``jax.distributed.initialize``: multi-controller JAX runs one
process per host, each addressing its own devices, and every process runs
the same program (SPMD).  Here one process (a *rank*) runs per part of a
partitioned matrix, on a device of its own or on a card that several ranks
share, joined by ``torch.distributed``:

* :func:`init_world` joins this process to a world of ``world`` ranks,
  through a ``FileStore`` at a path (or a given store), or through the
  environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``).
* :func:`spawn` starts ``n`` ranks on this machine (``spawn`` start method,
  never ``fork``), runs ``fn(world, *args)`` in each and returns their
  results in rank order.  A rank that raises fails the whole call with that
  rank's traceback; a call that outlasts ``timeout`` fails naming the ranks
  that did not finish.  Every rank is stopped before it returns.

The backend is the caller's choice and nothing falls back:

* ``"nccl"`` needs a CUDA device per rank, each a different card.  Two
  ranks that name one card raise before NCCL starts (NCCL refuses them).
* ``"gloo"`` runs on the host.  With CUDA tensors every collective is
  staged through pinned host buffers (:mod:`repro_torch.core.collectives`);
  records name that transport ``"gloo-host-staged"``.  This is how several
  ranks share one card.
* No entry point picks the CPU or gloo by itself: a rank's device defaults
  to ``cuda:<local rank>`` and raises where there is none.

``World.made`` keeps what was made collectively over a world, once each:
its process meshes by grid (:func:`repro_torch.core.mesh.world_mesh`) and,
once a led engine (``repro_torch.engine.SpmvEngine(world=)``) opened on
it, the control channel on which rank 0 leads the other ranks
(:func:`repro_torch.core.control.channel`, ``World.control``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["World", "BACKENDS", "init_world", "close_world", "spawn",
           "device_key", "check_devices", "RankFailed", "DEFAULT_TIMEOUT_S"]

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 300.0
_KEY = "repro_torch/device/{}"


class RankFailed(RuntimeError):
    """A rank of a spawned world raised, died or did not finish in time."""


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in a world of ranks."""

    backend: str  # "gloo" | "nccl" | "dry" (mesh.dry_process_mesh: never joined)
    rank: int
    size: int
    device: torch.device  # where this rank's part lies
    timeout: float = DEFAULT_TIMEOUT_S  # seconds a collective may wait
    # made collectively over this world, once each: process meshes by
    # (shape, axis names) (mesh.world_mesh), "control" (control.channel)
    made: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)

    @property
    def control(self):
        """The control channel of a led engine (core/control.py), None
        until one opened on this world."""
        return self.made.get("control")

    @property
    def transport(self) -> str:
        """How the collectives move data: ``"nccl"``, ``"gloo"`` (CPU
        tensors) or ``"gloo-host-staged"`` (CUDA tensors over gloo)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo-host-staged"
        return self.backend


def device_key(device: torch.device) -> str:
    """The physical device a rank names: host and CUDA UUID (or ordinal),
    so two ordinals that reach one card under different
    ``CUDA_VISIBLE_DEVICES`` compare equal.  A CPU device is the process's
    own."""
    if device.type == "cpu":
        return f"{socket.gethostname()}:cpu:{os.getpid()}"
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}:cuda:{uuid if uuid is not None else device.index}"


def check_devices(backend: str, keys: Sequence[str]) -> None:
    """Raise where ``backend`` cannot run on the ranks' devices ``keys``
    (:func:`device_key`, in rank order): NCCL refuses two ranks on one
    card."""
    if backend != "nccl":
        return
    first = {}
    for rank, key in enumerate(keys):
        if key in first:
            raise ValueError(
                f"backend='nccl' cannot run ranks {first[key]} and {rank} on "
                f"one device ({key}): NCCL refuses duplicate GPUs; give each "
                "rank its own card, or pass backend='gloo' to share one "
                "(host-staged collectives)")
        first[key] = rank


def _resolve_device(device, local_rank: int) -> torch.device:
    device = torch.device(f"cuda:{local_rank}" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for but no CUDA device "
                               "is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def _store(store, rank: int, world: int):
    if isinstance(store, dist.Store):
        return store
    if isinstance(store, (str, os.PathLike)):
        return dist.FileStore(os.fspath(store), world)
    if store is not None:
        raise TypeError(f"store must be a path, a torch.distributed.Store or "
                        f"None (torchrun's environment); got {store!r}")
    host, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    return dist.TCPStore(host, port, world, rank == 0)


def init_world(backend: str, rank: Optional[int] = None,
               world: Optional[int] = None, store=None, *, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> World:
    """Join this process to a world of ``world`` ranks as ``rank``.

    Args:
      backend: "gloo" or "nccl" (no default, no fallback).
      rank, world: this rank and the world size; None reads ``RANK`` /
        ``WORLD_SIZE`` (torchrun).
      store: a ``FileStore`` path shared by the ranks, a
        ``torch.distributed.Store``, or None for torchrun's
        ``MASTER_ADDR`` / ``MASTER_PORT``.
      device: this rank's device; None is ``cuda:<LOCAL_RANK>`` (or
        ``cuda:<rank>``).  Ranks may share a card only over gloo.
      timeout: seconds any collective may wait for the other ranks.

    Raises:
      ValueError: an unknown backend, NCCL on a CPU device, or NCCL with
        two ranks on one device (checked through the store, before NCCL
        starts).
      RuntimeError: a CUDA device is asked for and none is present.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl" and device is not None \
            and torch.device(device).type != "cuda":
        raise ValueError(f"backend='nccl' needs a CUDA device; got {device}")
    store = _store(store, rank, world)
    device = _resolve_device(device, local_rank)
    # every rank posts its device and reads the others' before any backend
    # starts, so a refused layout fails on every rank with the same error
    store.set(_KEY.format(rank), device_key(device))
    check_devices(backend, [store.get(_KEY.format(r)).decode()
                            for r in range(world)])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return World(backend, rank, world, device, timeout)


def close_world() -> None:
    """Leave the world (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, n, backend, device, store_path, args, results,
               timeout):
    """A spawned rank: join, run ``fn``, post ``(rank, ok, result or
    traceback)``, leave."""
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        world = init_world(backend, rank, n, store_path, device=device,
                           timeout=timeout)
        try:
            out = fn(world, *args)
        finally:
            close_world()
        # pickled by value here: the queue's own pickler would share a
        # tensor's storage with a process that is about to exit
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # posted to the spawner, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, backend: str, device=None, args: tuple = (),
          timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(world, *args)`` on ``n`` ranks of a new world; returns the
    ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and every
    rank starts from a fresh import: guard a script's work with ``if
    __name__ == "__main__":``.  ``device`` is one device for every rank
    (e.g. ``"cuda:0"`` for ranks sharing a card, ``"cpu"``), or None for
    ``cuda:<rank>``.  The ranks meet on a ``FileStore`` in a fresh
    temporary directory.

    Raises:
      ValueError: as :func:`init_world`, before any rank starts where the
        devices are named (NCCL on one device twice).
      RankFailed: a rank raised or died (its traceback or exit code), or
        the ranks did not all finish within ``timeout`` seconds.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if device is not None:
        device = torch.device(device)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"backend='nccl' needs a CUDA device; got {device}")
        if device.index is not None:  # every rank names this one device
            check_devices(backend, [str(device)] * n)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, device,
                               os.path.join(tmp, "store"), args, results,
                               timeout))
             for r in range(n)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if gone:  # a last post may still be in flight
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RankFailed(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    late = [r for r in range(n) if r not in out]
                    raise RankFailed(f"ranks {late} did not finish within "
                                     f"{timeout:.0f} s")
                else:
                    continue
            if not ok:
                raise RankFailed(f"rank {rank} of {n} ({backend}) failed:\n"
                                 f"{value}")
            out[rank] = value
        return [pickle.loads(out[r]) for r in range(n)]
    finally:
        if len(out) == n:  # every rank posted: let each leave on its own
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
