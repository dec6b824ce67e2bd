"""repro_torch.topo — topology-aware mesh placement for the 2D schemes.

Counterpart of ``repro/topo``.  SparseP's 2D results hinge on *which
partition axis pays the expensive transfers* (x-broadcast vs partial
merge); this package models the physical interconnect and maps logical
mesh axes onto it:

    from repro_torch.topo import FakeTopology, build_mesh

    topo = FakeTopology.pim_like((2, 2), devices=["cuda"] * 4)
    mesh, assignment = build_mesh(topo, (2, 2))      # contiguous-mesh trick
    pln = sm.plan(scheme="2d", topology=topo)         # or end to end

``SparseMatrix.plan(topology=...)`` wires the whole chain: ``fit_plan``
ranks candidate 2D grids by modelled collective cost, ``build_mesh`` lays
the winning grid out so the network-intensive logical axis rides the
fastest declared links, and the resulting
:class:`~repro_torch.api.plan.ExecutionPlan` carries the chosen
:class:`AxisAssignment` through ``scheme_id``, ``describe()``, the plan IR
(v2) and the tuning cache.  On one card the placement is recorded
(``Mesh.slots``) and the parts still run in one part-axis launch; the
prices are modelled on the declared links, not times of the card.
"""
from .cost import CollectiveCostModel
from .mesh import build_mesh
from .topology import (
    AxisAssignment,
    DeviceTopology,
    FakeTopology,
    LinkSpec,
    detect_topology,
)

__all__ = [
    "LinkSpec",
    "AxisAssignment",
    "DeviceTopology",
    "FakeTopology",
    "detect_topology",
    "CollectiveCostModel",
    "build_mesh",
]
