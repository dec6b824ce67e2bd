"""Physical device topology — the ground truth under mesh placement.

Counterpart of ``repro/topo/topology.py``, with the same names, validation
messages and link constants, so both packages price every assignment the
same.  SparseP's 2D results (Figs. 17-24) rest on *which physical axis*
each logical mesh axis lands on: the x-broadcast crosses the ``rows`` axis
and the partial-result merge crosses the ``cols`` axis
(:func:`repro_torch.core.distributed.spmv_2d`), and those two transfers can
carry very different byte counts.

* :class:`LinkSpec` — per-axis link bandwidth (bytes/s) and per-step latency.
* :class:`DeviceTopology` — named physical axes, their sizes and links, plus
  (optionally) the device grid.  :meth:`DeviceTopology.assignments`
  enumerates every contiguous layout of a logical mesh shape onto the
  physical axes, and :meth:`DeviceTopology.device_order` realizes one as a
  flat device list.
* :class:`FakeTopology` — a declared topology with declared link speeds;
  :meth:`FakeTopology.pim_like` is the PIM-flavoured preset (slow
  through-host axis, fast in-bank axis).
* :func:`detect_topology` — one flat axis with ``HOST_LINK`` over the given
  torch devices, as the reference answers for every non-TPU platform.

The link constants are the reference's *modelled* defaults: they rank
placements and are not a rate of any card.  With every part on one card
(:mod:`repro_torch.core.mesh`), a placement is metadata — the part-axis
launch is the same whichever assignment wins.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "LinkSpec",
    "AxisAssignment",
    "DeviceTopology",
    "FakeTopology",
    "detect_topology",
]


@dataclass(frozen=True)
class LinkSpec:
    """One physical axis's link: per-hop bandwidth and per-step latency.

    ``bandwidth`` is bytes/second along the axis; ``latency`` is seconds per
    collective step.  The cost model combines them as
    ``bytes * (n-1)/n / bandwidth + ceil(log2 n) * latency``.
    """

    bandwidth: float
    latency: float

    def __post_init__(self):
        if self.bandwidth <= 0 or self.latency < 0:
            raise ValueError(
                f"LinkSpec needs bandwidth > 0 and latency >= 0, got "
                f"bandwidth={self.bandwidth!r} latency={self.latency!r}"
            )


# the reference's modelled link constants (a TPU ICI axis, and a host
# interconnect stand-in); FakeTopology defaults to the first
ICI_LINK = LinkSpec(bandwidth=90e9, latency=1e-6)
HOST_LINK = LinkSpec(bandwidth=10e9, latency=20e-6)


@dataclass(frozen=True)
class AxisAssignment:
    """One mapping of logical mesh axes onto groups of physical axes.

    ``logical`` names the mesh axes (e.g. ``("rows", "cols")``); ``physical``
    holds, per logical axis, the tuple of physical axis names whose combined
    extent realizes it.  A size-1 logical axis maps to the empty group.  The
    assignment is pure metadata — hashable, JSON-able via :meth:`to_dict` —
    so it rides in the plan IR and in tuning-cache records.
    """

    logical: Tuple[str, ...]
    physical: Tuple[Tuple[str, ...], ...]

    def __post_init__(self):
        if len(self.logical) != len(self.physical):
            raise ValueError("logical/physical arity mismatch")

    @property
    def tag(self) -> str:
        """Compact stable identity, e.g. ``rows=host,cols=bank``."""
        return ",".join(
            f"{l}={'*'.join(p) if p else '-'}"
            for l, p in zip(self.logical, self.physical)
        )

    def group(self, axis: str) -> Tuple[str, ...]:
        """The physical axis group carrying logical ``axis``."""
        try:
            return self.physical[self.logical.index(axis)]
        except ValueError:
            raise KeyError(f"no logical axis {axis!r} in {self.logical}")

    def to_dict(self) -> dict:
        return {
            "logical": list(self.logical),
            "physical": [list(g) for g in self.physical],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AxisAssignment":
        return cls(
            logical=tuple(str(a) for a in d["logical"]),
            physical=tuple(tuple(str(p) for p in g) for g in d["physical"]),
        )


class DeviceTopology:
    """Named physical axes + links, optionally bound to a device grid.

    Args:
      axis_names: physical axis names, e.g. ``("host", "bank")``.
      axis_sizes: extent of each axis; their product is the device count.
      links: one :class:`LinkSpec` per axis.
      devices: optional flat device sequence (row-major over ``axis_sizes``;
        torch devices or their names, e.g. ``["cuda"] * 4``) or an object
        ndarray already shaped ``axis_sizes``.  ``None`` leaves the
        topology abstract (cost modelling only; ``device_order`` then needs
        devices passed in).
      name: short identity; rides in plan IR / tuning keys.
    """

    def __init__(
        self,
        axis_names: Sequence[str],
        axis_sizes: Sequence[int],
        links: Sequence[LinkSpec],
        *,
        devices=None,
        name: str = "topology",
    ):
        self.axis_names = tuple(str(a) for a in axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.links = tuple(links)
        self.name = str(name)
        if not self.axis_names:
            raise ValueError("a topology needs at least one physical axis")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names: {self.axis_names}")
        if not (len(self.axis_names) == len(self.axis_sizes) == len(self.links)):
            raise ValueError("axis_names/axis_sizes/links lengths differ")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")
        for spec in self.links:
            if not isinstance(spec, LinkSpec):
                raise TypeError(
                    f"links must be LinkSpec, got {type(spec).__name__}"
                )
        self.devices = None
        if devices is not None:
            grid = np.asarray(devices, dtype=object)
            if grid.size != self.n_devices:
                raise ValueError(
                    f"{grid.size} devices cannot fill axes {self.axis_sizes} "
                    f"({self.n_devices} slots)"
                )
            self.devices = grid.reshape(self.axis_sizes)

    # ------------------------------------------------------------ inspection

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.axis_sizes))

    def link(self, axis: str) -> LinkSpec:
        """The :class:`LinkSpec` of physical axis ``axis``."""
        try:
            return self.links[self.axis_names.index(axis)]
        except ValueError:
            raise KeyError(f"no physical axis {axis!r} in {self.axis_names}")

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes[self.axis_names.index(axis)]

    def flat_devices(self) -> Optional[list]:
        """Row-major flat device list, or None for an abstract topology."""
        return None if self.devices is None else list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        axes = ", ".join(
            f"{a}:{s}" for a, s in zip(self.axis_names, self.axis_sizes)
        )
        return f"{type(self).__name__}({self.name!r}, {axes})"

    # ------------------------------------------------------------ assignments

    def assignments(
        self, mesh_shape: Sequence[int], axis_names: Sequence[str]
    ) -> list:
        """Every contiguous layout of ``mesh_shape`` onto the physical axes.

        Enumerates ordered partitions of the physical axes into
        ``len(mesh_shape)`` groups whose size products match the logical
        sizes (permuting physical axes first).  A logical axis of size 1
        takes the empty group.  Returns ``[]`` when the logical shape cannot
        be realized contiguously (e.g. a 3-wide axis on 2x2 hardware) —
        callers then fall back to flat device order with no assignment.
        """
        mesh_shape = tuple(int(s) for s in mesh_shape)
        axis_names = tuple(str(a) for a in axis_names)
        if len(mesh_shape) != len(axis_names):
            raise ValueError("mesh_shape/axis_names arity mismatch")
        if int(np.prod(mesh_shape)) != self.n_devices:
            return []
        out, seen = [], set()
        for perm in itertools.permutations(range(len(self.axis_names))):
            groups = self._split(perm, mesh_shape)
            if groups is None or groups in seen:
                continue
            seen.add(groups)
            out.append(
                AxisAssignment(
                    logical=axis_names,
                    physical=tuple(
                        tuple(self.axis_names[i] for i in g) for g in groups
                    ),
                )
            )
        return out

    def _split(self, perm, mesh_shape):
        """Greedily split permuted axes into groups matching mesh_shape."""
        groups, it = [], 0
        for want in mesh_shape:
            got, group = 1, []
            while got < want:
                if it >= len(perm):
                    return None
                got *= self.axis_sizes[perm[it]]
                group.append(perm[it])
                it += 1
            if got != want:
                return None
            groups.append(tuple(group))
        if it != len(perm):
            # leftover physical axes: only size-1 ones can be absorbed
            if any(self.axis_sizes[i] != 1 for i in perm[it:]):
                return None
        return tuple(groups)

    def device_order(self, assignment: AxisAssignment, devices=None) -> list:
        """Flat device list realizing ``assignment`` (contiguous-mesh trick).

        Transposes the physical device grid so the axes appear in assignment
        group order, then flattens row-major: reshaping that list to the
        logical mesh shape puts each logical axis's neighbours on the
        physical links of its group.

        Args:
          assignment: one of :meth:`assignments`.
          devices: flat device list to arrange when the topology itself is
            abstract (``devices=None`` at construction).

        Raises:
          ValueError: abstract topology and no ``devices`` given, or a
            device count that does not fill the grid.
        """
        grid = self.devices
        if grid is None:
            if devices is None:
                raise ValueError(
                    f"topology {self.name!r} is abstract; pass devices= to "
                    "realize an assignment"
                )
            devices = list(devices)
            if len(devices) < self.n_devices:
                raise ValueError(
                    f"need {self.n_devices} devices for axes "
                    f"{self.axis_sizes}, got {len(devices)}"
                )
            grid = np.asarray(
                devices[: self.n_devices], dtype=object
            ).reshape(self.axis_sizes)
        order = [self.axis_names.index(a) for g in assignment.physical for a in g]
        order += [i for i in range(len(self.axis_names)) if i not in order]
        return list(grid.transpose(order).reshape(-1))


class FakeTopology(DeviceTopology):
    """A declared topology for CPU CI, cost-model tests and one card.

    Identical to :class:`DeviceTopology` mechanically — it makes the "I
    declare these axes and link speeds over these devices" use explicit,
    and carries presets.  Only the link speeds are simulated; on one card
    the placement is recorded (``Mesh.slots``) and prices the plan, and the
    parts still run in one launch.
    """

    def __init__(self, axis_sizes, *, axis_names=None, links=None,
                 devices=None, name="fake"):
        axis_sizes = tuple(int(s) for s in axis_sizes)
        if axis_names is None:
            axis_names = tuple(f"ax{i}" for i in range(len(axis_sizes)))
        if links is None:
            links = tuple(ICI_LINK for _ in axis_sizes)
        super().__init__(axis_names, axis_sizes, links, devices=devices,
                         name=name)

    @classmethod
    def pim_like(cls, shape=(2, 2), *, devices=None) -> "FakeTopology":
        """The PIM-flavoured 2-axis preset: slow host axis, fast bank axis.

        ``host`` models inter-DPU communication bouncing through host DRAM
        (SparseP's retrieve bottleneck, Obs. 12); ``bank`` models bank-local
        streaming.  The asymmetry is ~1000x in bandwidth.  Modelled links
        only: no card or TPU has these rates.
        """
        if len(shape) != 2:
            raise ValueError(f"pim_like is a 2-axis preset, got shape {shape}")
        return cls(
            shape,
            axis_names=("host", "bank"),
            links=(
                LinkSpec(bandwidth=1e6, latency=50e-6),   # through host DRAM
                LinkSpec(bandwidth=1e9, latency=1e-6),    # in-bank
            ),
            devices=devices,
            name=f"pim{shape[0]}x{shape[1]}",
        )


def detect_topology(devices=None) -> DeviceTopology:
    """The topology of a pool of torch devices: one flat axis.

    The reference reads TPU coordinates when it has them and degrades to
    one flat axis with ``HOST_LINK`` for every other platform, named
    ``<platform>:flat``; torch devices carry no coordinates, so the port
    always gives that flat answer — placement is then a no-op and every
    assignment prices the same.

    Args:
      devices: torch devices or their names (``["cuda"] * 16``: 16 parts of
        one card).  Default: the current CUDA device.

    Raises:
      RuntimeError: ``devices`` omitted and no CUDA device present (there
        is no fallback to the CPU).
      ValueError: an empty pool.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("detect_topology() needs a CUDA device; pass "
                               "devices=['cpu'] * n for the CPU")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = list(devices)
    if not devices:
        raise ValueError("no devices")
    plat = torch.device(devices[0]).type
    return DeviceTopology(
        ("flat",), (len(devices),), (HOST_LINK,),
        devices=np.asarray(devices, dtype=object),
        name=f"{plat}:flat",
    )
