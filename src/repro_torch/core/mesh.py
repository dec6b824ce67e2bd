"""Mesh — a named grid of torch devices for the partitioned schemes.

Counterpart of ``repro.compat.make_mesh`` (a ``jax.sharding.Mesh``): an
(P,) or (R, C) grid of devices with axis names, ``AXIS_1D`` for 1D plans
and ``AXES_2D`` for 2D ones.  A part of a partitioned matrix runs on the
device at its place in the grid.

Two kinds of mesh:

* :class:`Mesh` (:func:`make_mesh`): every place of the grid holds the same
  device.  All parts lie on one card (or on the CPU) and each collective is
  a tensor operation on the part axis (:mod:`repro_torch.core.distributed`).
  A grid that names distinct devices raises (:func:`same_device`): one
  process cannot drive them; use a process mesh.
* :class:`ProcessMesh` (:func:`make_process_mesh`): the places of the grid
  are the ranks of a ``torch.distributed`` world
  (:mod:`repro_torch.core.world`), place ``p`` (row-major) rank ``p``.
  Every rank holds only its own part, on its own device, and the
  collectives are real ones over each axis's process group
  (:mod:`repro_torch.core.collectives`), as the JAX package's
  ``shard_map`` runs one part per device.  It is built on
  ``torch.distributed.device_mesh.init_device_mesh``, which gives each
  axis its own group.

Since every place holds the same device, the order a topology gives the
devices (:func:`repro_torch.topo.build_mesh`) would be invisible in
``devices``; ``Mesh.slots`` records it instead: at each place of the grid,
that place's position in the topology's flat device order (``arange`` for
a flat mesh) — what the JAX mesh shows as its devices' ids.  It is
metadata: the parts run in logical order in the one part-axis launch.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "ProcessMesh", "make_mesh", "make_process_mesh",
           "dry_process_mesh", "world_mesh", "world_grids", "AXIS_1D",
           "AXES_2D", "same_device"]

# Canonical mesh axis names (the JAX package's api-built meshes)
AXIS_1D = "parts"
AXES_2D = ("rows", "cols")


def _normal(device) -> torch.device:
    """A torch.device with an explicit index for CUDA ("cuda" -> "cuda:k",
    k the current device, or 0 on a machine without one)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        k = torch.cuda.current_device() if torch.cuda.is_available() else 0
        device = torch.device("cuda", k)
    return device


def same_device(devices) -> torch.device:
    """The one device every entry of ``devices`` names.

    Raises:
      NotImplementedError: the entries name distinct devices.
      RuntimeError: a CUDA device is named and none is present.
    """
    devs = {_normal(d) for d in devices}
    if len(devs) != 1:
        raise NotImplementedError(
            f"one process cannot lay a mesh over distinct devices "
            f"{sorted(map(str, devs))}: run one rank per part on a process "
            "mesh (repro_torch.core.mesh.make_process_mesh over a "
            "repro_torch.core.world world): SpmvEngine(world=), "
            "SparseMatrix.plan(world=) and Tuner.tune(world=) serve, plan "
            "and tune on one; the cluster and topology= over one are later "
            "steps of ROADMAP.md's 'Multi-card meshes'")
    dev = devs.pop()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class Mesh:
    """A grid of torch devices with named axes (every place the same device)."""

    devices: np.ndarray  # object array of torch.device, shape = the grid
    axis_names: Tuple[str, ...]
    # int array, shape = the grid: each place's position in the topology's
    # flat device order
    slots: Optional[np.ndarray] = None

    def __post_init__(self):
        n = self.devices.size
        slots = np.asarray(range(n) if self.slots is None else self.slots,
                           dtype=np.int64)
        if sorted(slots.reshape(-1).tolist()) != list(range(n)):
            raise ValueError(f"mesh slots {slots.tolist()} are not a "
                             f"permutation of range({n})")
        object.__setattr__(self, "slots", slots.reshape(self.devices.shape))

    is_process = False  # see ProcessMesh

    @property
    def device(self) -> torch.device:
        """The device every part of this mesh runs on."""
        return self.devices.flat[0]

    @cached_property
    def memo(self) -> dict:
        """What is made once for this mesh and dropped with it, by the
        maker's key (``launch.steps.mesh_param_shardings``)."""
        return {}


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """A grid of the ranks of a ``torch.distributed`` world: place ``p``
    (row-major) is rank ``p``, whose part lies on its own device.

    ``devices`` holds every rank's device (as each rank names it), ``world``
    this process's :class:`~repro_torch.core.world.World`, ``groups`` one
    process group per axis (this rank's: the ranks that share its other
    coordinates, in axis order) and ``world_group`` the whole mesh's.
    """

    world: object = None  # repro_torch.core.world.World
    groups: Tuple = ()  # per axis, this rank's torch ProcessGroup
    world_group: object = None
    one_host: bool = False  # every rank runs on this rank's host

    is_process = True

    @cached_property
    def collectives(self):
        """This mesh's :class:`~repro_torch.core.collectives.Collectives`
        (``collectives_for``), one object for the mesh's life, so its
        counts add up over every call of a program; dropped with it."""
        from .collectives import collectives_for

        return collectives_for(self)

    @cached_property
    def host_mappings(self) -> dict:
        """The shared memory mappings of this mesh's process groups, by
        (group, slot size), made on first use by every collectives object
        of the mesh that moves data through shared memory, and dropped
        with the mesh."""
        return {}

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.world.device

    @property
    def rank(self) -> int:
        """This rank, which is also the flat place of its part."""
        return self.world.rank

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's place in the grid."""
        return tuple(int(i) for i in np.unravel_index(self.rank,
                                                      self.devices.shape))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None, slots: Optional[Sequence[int]] = None) -> Mesh:
    """Lay ``devices`` (default: the current CUDA device, repeated) out as a
    grid of ``axis_shapes`` named ``axis_names``; ``slots`` (flat, default
    ``arange``) is the places' topology order (see :class:`Mesh`).

    Raises:
      ValueError: the shape and names differ in length, the pool is too
        small for the grid, or ``slots`` is not a permutation of its places.
      NotImplementedError: the devices are distinct (see :func:`same_device`).
      RuntimeError: a CUDA device is named and none is present.
    """
    shape = tuple(int(n) for n in axis_shapes)
    names = tuple(str(a) for a in axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         f"in length")
    n = int(np.prod(shape))
    devices = ["cuda"] * n if devices is None else list(devices)
    if len(devices) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices; got {len(devices)}")
    dev = same_device(devices[:n])
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = dev
    return Mesh(grid.reshape(shape), names, slots)


def make_process_mesh(world, axis_shapes: Sequence[int],
                      axis_names: Sequence[str],
                      slots: Optional[Sequence[int]] = None) -> ProcessMesh:
    """Lay the ranks of ``world`` (:func:`repro_torch.core.world.init_world`)
    out as a grid of ``axis_shapes`` named ``axis_names``, rank ``p`` at
    flat place ``p``.  Collective: every rank calls it with the same
    arguments.  ``slots`` is metadata, as on :class:`Mesh`.  The mesh
    records whether every rank runs on one host (``one_host``), which
    decides how a gloo world's collectives move their data
    (``core/collectives.py``: ``collectives_for``).

    Raises:
      ValueError: the shape and names differ in length, or the grid's size
        is not the world's.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in axis_shapes)
    names = tuple(str(a) for a in axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         f"in length")
    n = int(np.prod(shape))
    if n != world.size:
        raise ValueError(f"a {shape} process mesh needs {n} ranks; the world "
                         f"has {world.size}")
    # the device mesh only makes the groups: NCCL's run on the card, gloo's
    # on host buffers (core/collectives.py stages CUDA tensors)
    dmesh = init_device_mesh("cuda" if world.backend == "nccl" else "cpu",
                             shape, mesh_dim_names=names)
    names_of = [None] * n
    dist.all_gather_object(names_of, str(world.device))
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(names_of):
        grid[i] = torch.device(d)
    hosts = [None] * n
    dist.all_gather_object(hosts, socket.gethostname())
    return ProcessMesh(grid.reshape(shape), names, slots, world=world,
                       groups=tuple(dmesh.get_group(a) for a in names),
                       world_group=dist.group.WORLD,
                       one_host=len(set(hosts)) == 1)


def world_grids(n: int) -> list:
    """Every (shape, axis names) a plan fitted to ``n`` parts can take: the
    1D ``(n,)`` and each 2D ``(r, n / r)`` (``api.plan.fit_plan`` fits every
    grid to exactly ``n`` places)."""
    return [((n,), (AXIS_1D,))] + [((r, n // r), AXES_2D)
                                   for r in range(1, n + 1) if n % r == 0]


def world_mesh(world, shape: Sequence[int], axis_names: Sequence[str]
               ) -> ProcessMesh:
    """The process mesh of ``shape`` over ``world``, made once
    (:func:`make_process_mesh`, collective) and kept in ``world.made``.

    Raises:
      RuntimeError: the mesh is not made yet and rank 0 leads the world
        (``world.control.leading``): a led world makes its meshes inside a
        command, or when every rank opens the engine, never on the leader
        alone (the others would never join the collective).
    """
    key = (tuple(int(n) for n in shape), tuple(str(a) for a in axis_names))
    mesh = world.made.get(key)
    if mesh is None:
        ctl = world.control
        if ctl is not None and ctl.leading:
            raise RuntimeError(
                f"no {key[0]} process mesh over this led world: a led world "
                "makes every grid of its size as the engine opens "
                "(mesh.world_grids)")
        mesh = world.made[key] = make_process_mesh(world, *key)
    return mesh


def dry_process_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
                     rank: int = 0) -> ProcessMesh:
    """A process mesh of ``prod(axis_shapes)`` ranks that is never joined,
    seen from ``rank`` (on the CPU): its programs run one rank's part and
    their collectives only count (``core/collectives.py``'s
    ``CountingCollectives``).  For counting a rank of a mesh larger than
    any world at hand (the SpMV dry run's 256 and 512)."""
    from .world import World

    shape = tuple(int(n) for n in axis_shapes)
    names = tuple(str(a) for a in axis_names)
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = torch.device("cpu")
    return ProcessMesh(grid.reshape(shape), names,
                       world=World("dry", int(rank), n, torch.device("cpu")),
                       groups=(None,) * len(shape))
