"""CandidateGenerator — the search space of the measure-and-refine loop.

Counterpart of ``repro/tune/candidates.py``.  Enumerates plausible
ExecutionPlans for one matrix on one device pool: the analytic schemes from
:func:`repro_torch.core.adaptive.enumerate_schemes` (paper-rule pick first,
alternates ranked by the analytic cost model), crossed with the requested
kernel impls, fitted to the pool by the same ``repro_torch.api.fit_plan``
rules every other entry point uses, and deduplicated by fitted identity.
Candidates that cannot be planned on the given mesh/devices (grid-shape
mismatch, unfit formats) are silently dropped — the tuner only measures
what would actually compile.

The impls are the port's: ``"cuda"`` (the hand-written kernels, the
counterpart of the reference's ``"pallas"``) and ``"torch"`` (the plain
oracles, the counterpart of ``"xla"``).  The default searches ``"cuda"``,
as ``SparseMatrix.plan`` defaults to it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..core.adaptive import HardwareModel, enumerate_schemes

__all__ = ["CandidateGenerator"]


@dataclass
class CandidateGenerator:
    """Enumerate candidate ExecutionPlans from matrix stats.

    Attributes:
      impls: kernel impls to cross the schemes with ("cuda" and/or "torch").
      include_exotic: also try the 2D equally-wide / variable-sized schemes
        the analytic rules never auto-select (paper Obs. 14).
      max_candidates: hard cap on the number of plans returned (the analytic
        pick always survives the cut).
    """

    impls: Tuple[str, ...] = ("cuda",)
    include_exotic: bool = False
    max_candidates: int = 8

    def plans(
        self,
        matrix,
        *,
        device="cuda",
        devices=None,
        mesh=None,
        block: Tuple[int, int] = (8, 16),
        hw: Optional[HardwareModel] = None,
        topology=None,
    ) -> list:
        """Candidate ExecutionPlans for ``matrix`` on the given pool.

        Args:
          matrix: a :class:`repro_torch.api.SparseMatrix`.
          device: the device of single-device candidates ("cuda" or "cpu").
          devices/mesh: the placement the plans are fitted to (both omitted
            means single-device execution on ``device``, where candidates
            differ by container format and impl only).
          block: (r, c) tile for the block formats.
          hw: HardwareModel for the analytic ranking (default: one chip per
            device in the pool).
          topology: a :class:`repro_torch.topo.DeviceTopology` — each
            distributed candidate is then expanded into one plan *per viable
            axis assignment* (model-ranked order), so the measurements can
            overrule the cost model's placement pick, not just its scheme
            pick.  Assignment-expanded candidates count against
            ``max_candidates`` like any other.

        Returns:
          A list of ExecutionPlans, analytic pick first, capped at
          ``max_candidates``; never empty (the "auto" plan always fits).
        """
        if mesh is not None:
            n_devices = int(mesh.devices.size)
        elif devices is not None:
            n_devices = len(list(devices))
        else:
            n_devices = 1
        hw = hw if hw is not None else HardwareModel(chips=max(1, n_devices))
        schemes = enumerate_schemes(
            matrix.stats,
            hw,
            dtype_bytes=matrix.dtype.itemsize,
            include_exotic=self.include_exotic,
        )
        out, seen = [], set()

        def _admit(plan) -> None:
            # scheme_id includes the axis-assignment suffix, so two
            # placements of one scheme are distinct candidates
            key = (plan.scheme_id, plan.impl, plan.grid)
            if key not in seen:
                seen.add(key)
                out.append(plan)

        for scheme in schemes:
            for impl in self.impls:
                if len(out) >= self.max_candidates:
                    return out
                try:
                    plan = matrix.plan(
                        scheme=scheme,
                        impl=impl,
                        device=device,
                        mesh=mesh,
                        devices=devices,
                        block=block,
                        hw=hw,
                        topology=topology,
                    )
                except ValueError:
                    continue  # unfit for this pool/mesh; not a candidate
                _admit(plan)
                if topology is None or plan.topo_assignment is None:
                    continue
                # expand: one candidate per alternative axis assignment of
                # the fitted grid (model pick already admitted above)
                from ..topo import CollectiveCostModel

                ranked = CollectiveCostModel(topology).rank(
                    plan.scheme, matrix.shape, matrix.dtype.itemsize,
                    plan.axes,
                )
                for alt, _price in ranked:
                    if len(out) >= self.max_candidates:
                        return out
                    try:
                        _admit(matrix.plan(
                            scheme=plan.scheme, impl=impl, device=device,
                            devices=devices, block=block, hw=hw,
                            topology=topology, assignment=alt,
                        ))
                    except ValueError:
                        continue
        return out
