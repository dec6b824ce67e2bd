"""CollectiveCostModel — price a plan's collectives per axis assignment.

Counterpart of ``repro/topo/cost.py``, a copy: the same float arithmetic in
the same order, so both packages give the same prices to the last bit.
The prices are *modelled* seconds on the topology's declared links, not a
time on any device: on one card every part runs in one launch whatever
the assignment.

The 2D SpMV program (:func:`repro_torch.core.distributed.spmv_2d`) has exactly two
transfer phases, and they cross *different* mesh axes:

* **x-broadcast (load)** — x is placed ``P(cols)``: sharded over the
  ``cols`` axis, replicated across the ``rows`` axis.  The replication is
  the paper's load-x-to-cores phase; its bytes cross the physical links
  carrying the ``rows`` axis.  Per chip: ``cols / C * dtype_bytes``.
* **partial merge (retrieve)** — ``psum`` / ``psum_scatter`` reduce the
  partial y over the ``cols`` axis (``rows / R * dtype_bytes * 2`` per chip,
  matching :func:`repro_torch.core.adaptive.estimate_time`); ``merge="global"``
  all-reduces a full row buffer over *both* axes (``rows * dtype_bytes * 2``)
  — the paper's faithful retrieve+merge path and its bottleneck (Obs. 12).

1D plans broadcast x over their single axis and merge via boundary
ppermute (priced as one latency step — negligible bytes).

A collective of ``b`` bytes over a physical axis group ``G`` (combined
extent ``n``) is priced with the standard ring/tree approximation::

    cost(G, n, b) = b * (n - 1) / n / min_bw(G) + ceil(log2 n) * max_lat(G)

The bottleneck bandwidth (``min`` over the group) and worst latency are the
conservative choice for a collective spanning heterogeneous links; a size-1
group is free.  This is a *ranking* model, not a simulator — it only has to
order axis assignments correctly, and ``repro_torch.tune`` measures real
candidates per assignment so the empirical path can overrule it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from .topology import AxisAssignment, DeviceTopology

__all__ = ["CollectiveCostModel"]


class CollectiveCostModel:
    """Prices plan traffic patterns against a :class:`DeviceTopology`."""

    def __init__(self, topology: DeviceTopology):
        self.topology = topology

    # ------------------------------------------------------------ primitives

    def group_cost(self, group: Tuple[str, ...], bytes_: float) -> float:
        """Cost of one collective of ``bytes_`` over physical ``group``."""
        if not group:
            return 0.0
        n = 1
        for a in group:
            n *= self.topology.axis_size(a)
        if n <= 1:
            return 0.0
        links = [self.topology.link(a) for a in group]
        bw = min(l.bandwidth for l in links)
        lat = max(l.latency for l in links)
        return bytes_ * (n - 1) / n / bw + math.ceil(math.log2(n)) * lat

    def traffic(self, plan, shape: Tuple[int, int],
                dtype_bytes: int) -> dict:
        """Per-chip transfer bytes of ``plan``, split by crossing axis.

        Returns ``{"load": (axis_name or None, bytes),
        "merge": (tuple of axis names, bytes)}`` where axis names are
        *logical* mesh axes ("rows"/"cols" for 2D, the single axis name
        implied by position 0 for 1D).
        """
        rows, cols = shape
        if plan.partitioning == "1d":
            n = plan.grid[0]
            return {
                "load": (0, math.ceil(cols / max(1, n)) * dtype_bytes * 1.0),
                "merge": ((0,), 0.0),  # boundary ppermute: latency only
            }
        R, C = plan.grid
        load = math.ceil(cols / C) * dtype_bytes * 1.0
        if plan.merge == "global":
            merge_axes, merge = (0, 1), rows * dtype_bytes * 2.0
        else:
            merge_axes, merge = (1,), math.ceil(rows / R) * dtype_bytes * 2.0
        return {"load": (0, load), "merge": (merge_axes, merge)}

    # ------------------------------------------------------------ pricing

    def price(self, plan, shape: Tuple[int, int], dtype_bytes: int,
              assignment: AxisAssignment) -> dict:
        """Predicted transfer split of ``plan`` under ``assignment``.

        Returns ``{"load_s", "merge_s", "total_s"}`` (seconds).
        """
        t = self.traffic(plan, shape, dtype_bytes)
        load_axis, load_bytes = t["load"]
        merge_axes, merge_bytes = t["merge"]
        load_s = self.group_cost(assignment.physical[load_axis], load_bytes)
        merge_s = sum(
            self.group_cost(assignment.physical[i], merge_bytes)
            for i in merge_axes
        )
        return {"load_s": load_s, "merge_s": merge_s,
                "total_s": load_s + merge_s}

    def rank(self, plan, shape: Tuple[int, int], dtype_bytes: int,
             axis_names: Sequence[str]) -> list:
        """All assignments of ``plan.grid`` onto the topology, cheapest first.

        Returns a list of ``(AxisAssignment, price_dict)`` sorted by
        ``total_s`` (ties broken by assignment tag for determinism); empty
        when the grid cannot be laid out contiguously.
        """
        grid = tuple(plan.grid)
        if plan.partitioning == "1d":
            grid, axis_names = (grid[0],), tuple(axis_names)[:1]
        cands = self.topology.assignments(grid, axis_names)
        priced = [(a, self.price(plan, shape, dtype_bytes, a)) for a in cands]
        priced.sort(key=lambda ap: (ap[1]["total_s"], ap[0].tag))
        return priced

    def best(self, plan, shape, dtype_bytes, axis_names) -> Optional[tuple]:
        """Cheapest ``(assignment, price)`` or None when nothing fits."""
        ranked = self.rank(plan, shape, dtype_bytes, axis_names)
        return ranked[0] if ranked else None

    def worst(self, plan, shape, dtype_bytes, axis_names) -> Optional[tuple]:
        """Most expensive ``(assignment, price)`` — the adversarial layout."""
        ranked = self.rank(plan, shape, dtype_bytes, axis_names)
        return ranked[-1] if ranked else None
