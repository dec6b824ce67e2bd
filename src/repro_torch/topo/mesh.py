"""build_mesh — topology-aware mesh construction.

Counterpart of ``repro/topo/mesh.py``: given a topology and a logical mesh
shape, pick (or accept) an :class:`~repro_torch.topo.AxisAssignment` and
build the mesh (:func:`repro_torch.core.mesh.make_mesh`) in the device
order that realizes it, each logical axis's neighbours on the physical
links assigned to it.  Every place of a port mesh holds the same device,
so the order is kept as the mesh's ``slots``: each place's position in the
topology's flat device order, as the JAX mesh shows its devices' ids.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.mesh import make_mesh
from .cost import CollectiveCostModel
from .topology import AxisAssignment, DeviceTopology

__all__ = ["build_mesh"]

# mirror repro_torch.core.mesh's axis names by rank
_DEFAULT_AXES = {1: ("parts",), 2: ("rows", "cols")}


def _slots(topology: DeviceTopology, assignment: AxisAssignment) -> list:
    """The positions, in the topology's flat order, of the devices that
    ``device_order`` lays out for ``assignment``."""
    abstract = DeviceTopology(topology.axis_names, topology.axis_sizes,
                              topology.links, name=topology.name)
    return abstract.device_order(assignment, devices=range(topology.n_devices))


def build_mesh(
    topology: DeviceTopology,
    mesh_shape: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
    *,
    assignment=None,
    intensity: Optional[dict] = None,
    devices=None,
) -> Tuple[object, Optional[AxisAssignment]]:
    """Build a mesh whose place order follows the topology.

    Args:
      topology: the physical :class:`~repro_torch.topo.DeviceTopology`.
      mesh_shape: logical mesh shape, e.g. ``(R, C)``.
      axis_names: logical axis names (default ``("parts",)`` /
        ``("rows", "cols")`` by rank).
      assignment: force a specific :class:`~repro_torch.topo.AxisAssignment`
        (or its ``to_dict`` form) instead of choosing one — how
        ``repro_torch.tune`` builds one candidate per assignment and how
        ``plan_from_ir`` re-realizes a recorded layout.
      intensity: relative network intensity per logical axis name (higher =
        more traffic).  When no assignment is forced, the chosen one
        minimizes ``sum(group_cost(group, intensity))``; omitted, every
        axis weighs 1.0.
      devices: flat device list realizing an *abstract* topology (ignored
        when the topology carries its own device grid).

    Returns:
      ``(mesh, assignment)`` — the assignment used, or ``None`` when the
      shape cannot be laid out contiguously (the mesh then takes the first
      devices in flat order, ``slots`` = ``arange``).
    """
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if axis_names is None:
        axis_names = _DEFAULT_AXES.get(len(mesh_shape))
        if axis_names is None:
            raise ValueError(
                f"no default axis names for a rank-{len(mesh_shape)} mesh; "
                "pass axis_names="
            )
    axis_names = tuple(str(a) for a in axis_names)
    if assignment is not None:
        if isinstance(assignment, dict):
            assignment = AxisAssignment.from_dict(assignment)
        order = topology.device_order(assignment, devices=devices)
        return make_mesh(mesh_shape, axis_names, order,
                         slots=_slots(topology, assignment)), assignment

    cands = topology.assignments(mesh_shape, axis_names)
    if not cands:
        flat = topology.flat_devices() or (list(devices) if devices else None)
        if flat is not None:
            flat = flat[: int(np.prod(mesh_shape))]
        return make_mesh(mesh_shape, axis_names, flat), None

    model = CollectiveCostModel(topology)
    weights = {a: 1.0 for a in axis_names}
    if intensity:
        weights.update({str(k): float(v) for k, v in intensity.items()})

    def score(a: AxisAssignment) -> tuple:
        s = sum(
            model.group_cost(a.physical[i], weights[name])
            for i, name in enumerate(axis_names)
        )
        return (s, a.tag)

    assignment = min(cands, key=score)
    order = topology.device_order(assignment, devices=devices)
    return make_mesh(mesh_shape, axis_names, order,
                     slots=_slots(topology, assignment)), assignment
