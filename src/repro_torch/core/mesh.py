"""Mesh — a named grid of torch devices for the partitioned schemes.

Counterpart of ``repro.compat.make_mesh`` (a ``jax.sharding.Mesh``): an
(P,) or (R, C) grid of devices with axis names, ``AXIS_1D`` for 1D plans
and ``AXES_2D`` for 2D ones.  A part of a partitioned matrix runs on the
device at its place in the grid.

Every place of a grid must hold the same device: all parts then lie on one
card (or on the CPU) and each collective is a tensor operation on the part
axis (:mod:`repro_torch.core.distributed`).  A grid that names distinct
devices raises: multi-card meshes over ``torch.distributed`` / NCCL are a
later item of ROADMAP.md, and no grid falls back to one device silently.

Since every place holds the same device, the order a topology gives the
devices (:func:`repro_torch.topo.build_mesh`) would be invisible in
``devices``; ``Mesh.slots`` records it instead: at each place of the grid,
that place's position in the topology's flat device order (``arange`` for
a flat mesh) — what the JAX mesh shows as its devices' ids.  It is
metadata: the parts run in logical order in the one part-axis launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "AXIS_1D", "AXES_2D", "same_device"]

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
            f"a mesh over distinct devices {sorted(map(str, devs))} is not "
            "ported yet: every part must lie on one device (see ROADMAP.md, "
            "'Multi-card meshes')")
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

    @property
    def device(self) -> torch.device:
        """The device every part of this mesh runs on."""
        return self.devices.flat[0]


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
