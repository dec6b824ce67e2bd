"""Tuner — the measure-and-refine loop over candidate ExecutionPlans.

Counterpart of ``repro/tune/tuner.py``.  SparseP's central finding is that
no single scheme wins everywhere (paper Obs. 15), and analytic cost models
of the kind in ``core/adaptive.py`` systematically mispredict on real
hardware.  The tuner therefore treats the analytic pick as a *hypothesis*:
enumerate a shortlist of candidates
(:class:`~repro_torch.tune.candidates.CandidateGenerator`), time each one
on representative inputs (:class:`~repro_torch.tune.measure.Measurer`),
keep the fastest, and persist the winner
(:class:`~repro_torch.tune.cache.TuningCache`)
so the same (matrix, topology, dtype, batch) never measures twice.

``SparseMatrix.plan(scheme="tune")`` is sugar over :meth:`Tuner.tune`;
``SpmvEngine(tune=True)`` runs the same loop in the background off live
traffic and swaps executors when a candidate clears the margin.  On the
card every candidate is compiled and timed for real: the COO/CSR kernel
runs the ``coo``/``csr`` candidates, the block kernel the ``bcoo``/``bcsr``
ones.  Under a ``topology`` the candidates are expanded per axis
assignment and the winner's record keeps its placement ("topo").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..core.adaptive import HardwareModel, Plan

from .cache import TuneKey, TuningCache, make_key, record_to_plan
from .candidates import CandidateGenerator
from .measure import Measurement, Measurer

__all__ = ["Tuner", "TuningResult"]


@dataclass
class TuningResult:
    """Outcome of one tuning run (or one cache hit)."""

    best: object  # ExecutionPlan, .measured populated
    best_measurement: Measurement
    baseline: Measurement  # the analytic pick (or caller-supplied incumbent)
    measurements: list = field(default_factory=list)  # all candidates
    key: Optional[TuneKey] = None
    from_cache: bool = False
    planned: int = 0  # candidates planned (0 on a cache hit)

    @property
    def speedup(self) -> float:
        """Measured baseline time / winner time (>= 1.0 by construction
        when the baseline was among the measured candidates)."""
        if self.best_measurement.mean_s <= 0:
            return 1.0
        return self.baseline.mean_s / self.best_measurement.mean_s

    def describe(self) -> str:
        lines = [
            f"tuned over {len(self.measurements)} candidates"
            + (" (cache hit: 0 measured)" if self.from_cache else "")
        ]
        for m in self.measurements:
            marker = "->" if m is self.best_measurement else "  "
            lines.append(f" {marker} {m.describe()}")
        lines.append(
            f"  winner {self.best_measurement.scheme_id} "
            f"impl={self.best_measurement.impl}: {self.speedup:.2f}x vs "
            f"analytic {self.baseline.scheme_id}"
        )
        return "\n".join(lines)


class Tuner:
    """Generate -> measure -> select -> persist, behind one call."""

    def __init__(
        self,
        generator: Optional[CandidateGenerator] = None,
        measurer: Optional[Measurer] = None,
        cache: Optional[TuningCache] = None,
    ):
        self.generator = generator if generator is not None else CandidateGenerator()
        self.measurer = measurer if measurer is not None else Measurer()
        self.cache = cache if cache is not None else TuningCache(path=None)

    # ------------------------------------------------------------------ API

    def tune(
        self,
        matrix,
        *,
        device="cuda",
        devices=None,
        mesh=None,
        block: Tuple[int, int] = (8, 16),
        hw: Optional[HardwareModel] = None,
        batch: Optional[int] = None,
        x=None,
        baseline: Optional[Tuple[Plan, str]] = None,
        topology=None,
    ) -> TuningResult:
        """Measure candidates for ``matrix`` and return the fastest plan.

        Args:
          matrix: a :class:`repro_torch.api.SparseMatrix`.
          device: the device of single-device tuning ("cuda" or "cpu").
          devices/mesh: device pool (omit both for single-device tuning).
          block: (r, c) tile for the block formats.
          hw: HardwareModel for candidate enumeration/estimates.
          batch: representative batch width B (keyed into the cache: the
            winner for B=1 SpMV and B=32 SpMM may legitimately differ).
          x: representative input override; default is the measurer's
            seeded standard-normal vector(s) — pass live traffic here.
          baseline: optional (Plan, impl) incumbent to measure alongside
            the generated candidates (the engine passes its current plan);
            default baseline is the analytic "auto" pick.
          topology: a :class:`repro_torch.topo.DeviceTopology` — candidates
            are then expanded per axis assignment (measured placements can
            overrule the cost model's pick), the topology name keys the
            cache, and the cached winner records its assignment so
            rebuilds reproduce the placement without re-measuring.

        Returns:
          A TuningResult; ``result.best.measured`` carries the measured
          numbers into ``ExecutionPlan.describe()``.

        Raises:
          RuntimeError: no candidate ran (every one raised).
          Exception: whatever a ``cuda`` candidate on a CUDA device raised —
            a kernel that fails to build or launch is a fault, not an unfit
            candidate, and must not leave the plain version to win.
        """
        key = make_key(
            matrix, device=device, devices=devices, mesh=mesh, batch=batch,
            impls=self.generator.impls, block=block, topology=topology,
        )
        record = self.cache.get(key)
        if record is not None and self._record_covers_baseline(record, baseline):
            return self._from_record(
                matrix, record, key, device=device,
                devices=devices, mesh=mesh, block=block, hw=hw,
                baseline=baseline, topology=topology,
            )
        plans = self.generator.plans(
            matrix, device=device, devices=devices, mesh=mesh, block=block,
            hw=hw, topology=topology,
        )
        if baseline is not None:
            base_plan, base_impl = baseline
            have = {(p.scheme_id, p.impl) for p in plans}
            try:
                inc = matrix.plan(
                    scheme=base_plan, impl=base_impl, device=device,
                    devices=devices, mesh=mesh, block=block, hw=hw,
                    topology=topology,
                )
                if (inc.scheme_id, inc.impl) not in have:
                    plans.insert(0, inc)
            except ValueError:
                pass  # incumbent no longer fits this pool; candidates stand
        if x is None:
            x = self.measurer.representative(matrix, batch=batch)
        measurements, kept = [], []
        for plan in plans:
            try:
                m = self.measurer.measure(plan, x)
            except Exception:
                if plan.impl == "cuda" and plan.device.type == "cuda":
                    raise
                continue  # a candidate that cannot run is not a winner
            measurements.append(m)
            kept.append(plan)
        if not kept:
            raise RuntimeError(
                "tuning measured zero runnable candidates "
                f"(of {len(plans)} planned) — the pool cannot run this matrix"
            )
        best_i = min(range(len(kept)), key=lambda i: measurements[i].mean_s)
        base_m = self._baseline_measurement(kept, measurements, baseline)
        best_plan, best_m = kept[best_i], measurements[best_i]
        result = TuningResult(
            best=best_plan,
            best_measurement=best_m,
            baseline=base_m,
            measurements=measurements,
            key=key,
            from_cache=False,
            planned=len(plans),
        )
        best_plan.measured = self._measured_dict(result)
        self.cache.put(key, self._record(result))
        return result

    # ------------------------------------------------------------ internals

    @staticmethod
    def _record_covers_baseline(record: dict, baseline) -> bool:
        """A cached record only answers the caller's question when its
        recorded baseline IS the caller's incumbent (or no incumbent was
        given): otherwise result.baseline would describe a different plan's
        historical timing, and a margin comparison against it is
        meaningless — re-measure instead (and overwrite the record)."""
        if baseline is None:
            return True
        base_plan, base_impl = baseline
        want = (base_plan.tag, base_impl)
        recorded = (record.get("baseline_scheme_id"),
                    record.get("baseline_impl", record.get("impl")))
        measured = {(c.get("scheme_id"), c.get("impl"))
                    for c in record.get("candidates", [])}
        return recorded == want or want in measured

    @staticmethod
    def _baseline_measurement(plans, measurements, baseline) -> Measurement:
        """The incumbent's measurement: the caller-supplied (plan, impl)
        when given, else the analytic pick (always candidate #0)."""
        if baseline is not None:
            base_plan, base_impl = baseline
            for p, m in zip(plans, measurements):
                if (
                    p.scheme.partitioning == base_plan.partitioning
                    and p.scheme.scheme == base_plan.scheme
                    and p.fmt == base_plan.fmt
                    and p.impl == base_impl
                ):
                    return m
        return measurements[0]

    @staticmethod
    def _measured_dict(result: TuningResult) -> dict:
        m = result.best_measurement
        return {
            "mean_s": m.mean_s,
            "compile_s": m.compile_s,
            "phases": dict(m.phases),
            "baseline_scheme_id": result.baseline.scheme_id,
            "baseline_mean_s": result.baseline.mean_s,
            "speedup": result.speedup,
            "candidates": len(result.measurements),
            "planned": result.planned,
            "from_cache": result.from_cache,
        }

    def _record(self, result: TuningResult) -> dict:
        s = result.best.scheme
        return {
            "scheme": {
                "partitioning": s.partitioning,
                "scheme": s.scheme,
                "fmt": s.fmt,
                "merge": s.merge,
                "grid": list(s.grid),
                "reason": s.reason,
            },
            "impl": result.best.impl,
            "topo": result.best.topo_assignment,
            "mean_s": result.best_measurement.mean_s,
            "baseline_scheme_id": result.baseline.scheme_id,
            "baseline_impl": result.baseline.impl,
            "baseline_mean_s": result.baseline.mean_s,
            "speedup": result.speedup,
            "candidates": [
                {
                    "scheme_id": m.scheme_id,
                    "impl": m.impl,
                    "grid": list(m.grid),
                    "mean_s": m.mean_s,
                }
                for m in result.measurements
            ],
        }

    def _from_record(
        self, matrix, record: dict, key: TuneKey, *,
        device, devices, mesh, block, hw, baseline=None, topology=None,
    ) -> TuningResult:
        """Rebuild the cached winner WITHOUT re-measuring (the cache's whole
        point: re-register never pays the measurement loop again), in its
        recorded placement when it has one."""
        topo_rec = record.get("topo")
        assignment = None
        if topology is not None and topo_rec:
            assignment = {k: topo_rec[k] for k in ("logical", "physical")}
        plan = matrix.plan(
            scheme=record_to_plan(record),
            impl=record.get("impl", "cuda"),
            device=device, devices=devices, mesh=mesh, block=block, hw=hw,
            topology=topology, assignment=assignment,
        )
        best_m = Measurement(
            scheme_id=plan.scheme_id,
            impl=plan.impl,
            grid=plan.grid,
            fmt=plan.fmt,
            mean_s=float(record.get("mean_s", 0.0)),
            times_s=(),
            compile_s=0.0,
            phases={},
        )
        # the caller's incumbent (when given) may live in the record as a
        # candidate rather than as the recorded baseline — prefer its own
        # recorded timing (matched on scheme AND impl: a multi-impl record
        # can hold the same scheme under both impls with very different
        # times) so margin comparisons stay apples-to-apples
        base_id = record.get("baseline_scheme_id", best_m.scheme_id)
        base_impl = record.get("baseline_impl", plan.impl)
        base_s = float(record.get("baseline_mean_s", best_m.mean_s))
        if baseline is not None:
            bp, b_impl = baseline
            want = bp.tag
            for cand in record.get("candidates", []):
                if cand.get("scheme_id") == want and cand.get("impl") == b_impl:
                    base_id, base_impl = want, b_impl
                    base_s = float(cand.get("mean_s", base_s))
                    break
        base_m = Measurement(
            scheme_id=base_id,
            impl=base_impl,
            grid=plan.grid,
            fmt=plan.fmt,
            mean_s=base_s,
            times_s=(),
            compile_s=0.0,
            phases={},
        )
        result = TuningResult(
            best=plan,
            best_measurement=best_m,
            baseline=base_m,
            measurements=[],
            key=key,
            from_cache=True,
        )
        plan.measured = self._measured_dict(result)
        return result
