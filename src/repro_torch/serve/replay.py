"""Trace replay against an AsyncSpmvService, with an SLO report.

Counterpart of ``repro/serve/replay.py``.

The replayer is the serving layer's measurement harness: it fires a
:mod:`~repro_torch.serve.workload` trace at a service with faithful arrival
timing (optionally compressed), awaits every request, and folds the
outcomes into one :class:`SLOReport` — the numbers a serving PR should move
and a correctness PR must not:

  * latency percentiles (p50/p95/p99) and mean over completed requests,
  * reject rate, split by admission reason per tenant,
  * **zero-loss accounting**: every trace request must end *resolved* —
    completed, rejected, or errored; ``lost`` counts the remainder and a
    correct service reports 0,
  * late-service accounting: completions past their deadline (``late``) and
    infeasible requests that were served instead of shed
    (``infeasible_served``) — both must be 0 for SLO-honest serving,
  * per-SLO-class scorecards (completed/rejected/reasons + p50/p95/p99 per
    class — the rows the mixed-class smoke benchmark gates on),
  * fairness (Jain's index over completed vectors) scored *within* each
    class — cross-class imbalance is the scheduler honoring priorities,
    not a tenant being starved (docs/slo.md#fairness),
  * the paper's Fig.-17 load/kernel/retrieve split, aggregated from the
    engine's :class:`~repro_torch.engine.telemetry.Telemetry`,
  * **per-phase latency attribution** from the service's request traces
    (:mod:`repro_torch.obs`): p50/p95/p99 per lifecycle phase (admit, queue_wait,
    batch_form, load, kernel, retrieve, deliver) plus dedicated queue-wait
    stats and mean span coverage — where a p99 request's deadline went,
  * optional oracle verification: with ``oracles={name: dense}`` every
    completed y is compared against ``a @ x`` — max |err| always, and a
    bit-equality count for integer-valued workloads.  A dense oracle may
    also be a torch tensor, e.g. on the card, where a matrix too large for
    a host ``a @ x`` per request still fits.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.formats import torch_dtype
from ..obs.tracing import clock as obs_clock
from ..obs.tracing import trace_summary

from .admission import RequestRejected
from .workload import ServeRequest, request_vector

__all__ = ["SLOReport", "replay", "replay_sync"]


def _percentiles(lat_s: Sequence[float]) -> dict:
    if not lat_s:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
    arr = np.asarray(lat_s, dtype=np.float64) * 1e3
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(arr.mean()),
    }


def _jain(values: Sequence[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly even, 1/n = one tenant owns
    everything.  Defined over per-tenant completed vectors."""
    v = np.asarray([x for x in values], dtype=np.float64)
    if v.size == 0 or v.sum() <= 0:
        return 1.0
    return float(v.sum() ** 2 / (v.size * (v**2).sum()))


def _class_fairness(tenant_vectors: Dict[str, float],
                    classes: Dict[str, str]):
    """Jain fairness computed *within* each SLO class.

    A single cross-class Jain score misreads intentional prioritization as
    unfairness: an ``rt`` tenant out-completing a ``batch`` tenant under
    load is the scheduler working, not a tenant being starved.  Fairness is
    therefore scored per class — tenants only compete with peers under the
    same policy — and the headline number is the vector-weighted mean of
    the per-class indices (identical to the classic Jain score when every
    tenant shares one class).

    Returns:
      ``(fairness_by_class, overall)`` — {class: Jain index} and the
      weighted mean (1.0 when nothing completed).
    """
    by_class: Dict[str, list] = {}
    for tenant, vectors in tenant_vectors.items():
        cls = classes.get(tenant, "standard")
        by_class.setdefault(cls, []).append(vectors)
    fairness_by_class = {cls: _jain(v) for cls, v in sorted(by_class.items())}
    total = sum(sum(v) for v in by_class.values())
    if total <= 0:
        return fairness_by_class, 1.0
    overall = sum(fairness_by_class[cls] * sum(v)
                  for cls, v in by_class.items()) / total
    return fairness_by_class, float(overall)


@dataclass
class SLOReport:
    """Everything the replay observed, one serving scorecard."""

    requests: int = 0
    completed: int = 0
    rejected: int = 0
    errors: int = 0
    lost: int = 0  # unresolved requests — MUST be 0 for a correct service
    late: int = 0  # completed after their deadline (SLO miss)
    infeasible_served: int = 0  # should-have-shed requests served anyway
    infeasible_rejected: int = 0
    reject_reasons: Dict[str, int] = field(default_factory=dict)
    latency: dict = field(default_factory=dict)  # p50/p95/p99/mean (ms)
    per_tenant: Dict[str, dict] = field(default_factory=dict)
    # per-SLO-class scorecard: {class: completed/rejected/errors/vectors,
    # reject reasons, and p50/p95/p99/mean latency ms} (docs/slo.md)
    per_class: Dict[str, dict] = field(default_factory=dict)
    # Jain index *within* each class; cross-class imbalance is policy, not
    # unfairness (see _class_fairness)
    fairness_by_class: Dict[str, float] = field(default_factory=dict)
    fairness: float = 1.0  # vector-weighted mean of the per-class indices
    phases: dict = field(default_factory=dict)  # Fig.-17 load/kernel/retrieve
    # span-level attribution (from the service tracer, when enabled):
    # {phase: p50/p95/p99/mean ms + count} per lifecycle phase
    phase_latency: dict = field(default_factory=dict)
    queue_wait: dict = field(default_factory=dict)  # queue_wait ms stats
    span_coverage: float = 0.0  # mean (spanned time)/(e2e) over traces
    wall_s: float = 0.0
    verified: int = 0  # completions compared against the dense oracle
    bitexact: int = 0  # of those, bit-identical results
    max_abs_err: float = 0.0
    # solver sessions (trace entries with solve_steps set):
    solves: int = 0  # sessions completed
    solves_converged: int = 0  # of those, tol reached (steps-mode: N/A -> 0)
    solve_latency: dict = field(default_factory=dict)  # time-to-solution ms
    solve_iters: dict = field(default_factory=dict)  # iterations per session
    solve_per_iter_us: float = 0.0  # mean on-device us per SpMV step

    @property
    def reject_rate(self) -> float:
        return self.rejected / self.requests if self.requests else 0.0

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "requests": self.requests,
            "completed": self.completed,
            "rejected": self.rejected,
            "reject_rate": self.reject_rate,
            "reject_reasons": dict(self.reject_reasons),
            "errors": self.errors,
            "lost": self.lost,
            "late": self.late,
            "infeasible_served": self.infeasible_served,
            "infeasible_rejected": self.infeasible_rejected,
            "latency": dict(self.latency),
            "per_tenant": {t: dict(d) for t, d in self.per_tenant.items()},
            "per_class": {c: dict(d) for c, d in self.per_class.items()},
            "fairness": self.fairness,
            "fairness_by_class": dict(self.fairness_by_class),
            "phases": dict(self.phases),
            "phase_latency": {p: dict(d) for p, d in
                              self.phase_latency.items()},
            "queue_wait": dict(self.queue_wait),
            "span_coverage": self.span_coverage,
            "wall_s": self.wall_s,
            "throughput_rps": self.throughput_rps,
            "verified": self.verified,
            "bitexact": self.bitexact,
            "max_abs_err": self.max_abs_err,
            "solves": self.solves,
            "solves_converged": self.solves_converged,
            "solve_latency": dict(self.solve_latency),
            "solve_iters": dict(self.solve_iters),
            "solve_per_iter_us": self.solve_per_iter_us,
        }

    def describe(self) -> str:
        lat = self.latency or _percentiles(())
        lines = [
            f"SLO report: {self.requests} requests in {self.wall_s:.2f}s "
            f"({self.throughput_rps:.0f} done/s)",
            f"  completed={self.completed} rejected={self.rejected} "
            f"({100 * self.reject_rate:.1f}%) errors={self.errors} "
            f"lost={self.lost}",
            f"  latency ms: p50={lat['p50_ms']:.2f} p95={lat['p95_ms']:.2f} "
            f"p99={lat['p99_ms']:.2f} mean={lat['mean_ms']:.2f}",
            f"  deadlines: late={self.late} "
            f"infeasible served={self.infeasible_served} "
            f"shed={self.infeasible_rejected}",
            f"  fairness (vector-weighted within-class Jain): "
            f"{self.fairness:.3f}",
        ]
        if self.fairness_by_class:
            lines.append("  fairness by class: " + " ".join(
                f"{c}={v:.3f}" for c, v in
                sorted(self.fairness_by_class.items())))
        for cls in sorted(self.per_class):
            d = self.per_class[cls]
            lines.append(
                f"  [{cls}] completed={d['completed']} "
                f"rejected={d['rejected']} vectors={d['vectors']} "
                f"p50={d['p50_ms']:.2f}ms p99={d['p99_ms']:.2f}ms"
            )
        if self.reject_reasons:
            reasons = " ".join(f"{k}={v}" for k, v in
                               sorted(self.reject_reasons.items()) if v)
            lines.append(f"  reject reasons: {reasons or 'none'}")
        for tenant in sorted(self.per_tenant):
            d = self.per_tenant[tenant]
            lines.append(
                f"  {tenant}: completed={d['completed']} "
                f"rejected={d['rejected']} vectors={d['vectors']} "
                f"p99={d['p99_ms']:.2f}ms"
            )
        if self.phases:
            lines.append(
                f"  phase split (Fig. 17): load={self.phases['load']:.2f} "
                f"kernel={self.phases['kernel']:.2f} "
                f"retrieve={self.phases['retrieve']:.2f}"
            )
        if self.queue_wait:
            qw = self.queue_wait
            lines.append(
                f"  queue wait ms: p50={qw['p50_ms']:.2f} "
                f"p95={qw['p95_ms']:.2f} p99={qw['p99_ms']:.2f} "
                f"max={qw['max_ms']:.2f}"
            )
        if self.phase_latency:
            lines.append("  per-phase attribution (p50/p95/p99 ms):")
            for phase, d in self.phase_latency.items():
                lines.append(
                    f"    {phase}: {d['p50_ms']:.2f}/{d['p95_ms']:.2f}/"
                    f"{d['p99_ms']:.2f} (n={d['count']})"
                )
            lines.append(
                f"  span coverage (spanned/e2e): {self.span_coverage:.3f}"
            )
        if self.verified:
            lines.append(
                f"  oracle: {self.verified} verified, {self.bitexact} "
                f"bit-exact, max|err|={self.max_abs_err:.2e}"
            )
        if self.solves:
            sl = self.solve_latency or _percentiles(())
            lines.append(
                f"  solves: {self.solves} sessions "
                f"({self.solves_converged} converged), time-to-solution ms: "
                f"p50={sl['p50_ms']:.2f} p99={sl['p99_ms']:.2f}, "
                f"{self.solve_per_iter_us:.1f} us/iter"
            )
            if self.solve_iters:
                si = self.solve_iters
                lines.append(
                    f"  iterations/session: mean={si['mean']:.1f} "
                    f"p50={si['p50']:.0f} max={si['max']:.0f}"
                )
        return "\n".join(lines)


def _np_power(a, x0: np.ndarray, steps: int) -> np.ndarray:
    """Power-iteration reference (mirrors the device combine), computed
    where the oracle lies; returns a host array."""
    if isinstance(a, torch.Tensor):
        x = torch.from_numpy(x0).to(a.device, a.dtype)
        for _ in range(steps):
            y = a @ x
            x = y / torch.clamp_min(torch.linalg.vector_norm(y), 1e-30)
        return x.cpu().numpy()
    x = x0.astype(a.dtype, copy=True)
    for _ in range(steps):
        y = a @ x
        nrm = np.linalg.norm(y)
        x = y / max(nrm, 1e-30)
    return x


def _oracle(a, dtype):
    """A dense oracle in the payload dtype: a torch tensor where it lies,
    anything else as a host ndarray."""
    if isinstance(a, torch.Tensor):
        return a.to(torch_dtype(dtype))
    return np.asarray(a, dtype=dtype)


def _apply(a, x: np.ndarray) -> np.ndarray:
    """``a @ x`` on the host, computed where the oracle lies."""
    if isinstance(a, torch.Tensor):
        return (a @ torch.from_numpy(x).to(a.device)).cpu().numpy()
    return a @ x


def _aggregate_phases(telemetry) -> dict:
    """Total_s-weighted Fig.-17 split across every matrix the engine served."""
    total = load = kernel = retrieve = 0.0
    for bd in telemetry.breakdown().values():
        # breakdown() reports None fractions for matrices with zero total
        # phase time — they contribute nothing to the weighted split
        if bd["total_s"] <= 0 or bd["load"] is None:
            continue
        total += bd["total_s"]
        load += bd["load"] * bd["total_s"]
        kernel += bd["kernel"] * bd["total_s"]
        retrieve += bd["retrieve"] * bd["total_s"]
    if total <= 0:
        return {}
    return {"load": load / total, "kernel": kernel / total,
            "retrieve": retrieve / total, "total_s": total}


def _aggregate_spans(tracer, start_mark: float):
    """Fold the service tracer's spans (from this replay only) into
    per-phase latency stats, queue-wait stats, and mean span coverage.

    Returns ``(phase_latency, queue_wait, span_coverage)`` — empty/zero when
    the tracer is absent, disabled, or recorded nothing after
    ``start_mark``.
    """
    if tracer is None:
        return {}, {}, 0.0
    spans = [s for s in tracer.spans() if s.start_s >= start_mark]
    if not spans:
        return {}, {}, 0.0
    by_phase: Dict[str, list] = {}
    for s in spans:
        by_phase.setdefault(s.name, []).append(s.duration_s)
    phase_latency = {}
    for phase, durs in sorted(by_phase.items()):
        stats = _percentiles(durs)
        stats["count"] = len(durs)
        stats["total_s"] = float(sum(durs))
        phase_latency[phase] = stats
    queue_wait = {}
    qw = by_phase.get("queue_wait")
    if qw:
        queue_wait = _percentiles(qw)
        queue_wait["max_ms"] = float(max(qw) * 1e3)
        queue_wait["count"] = len(qw)
    summaries = trace_summary(spans)
    coverages = [d["coverage"] for d in summaries.values()
                 if d["total_s"] > 0]
    coverage = float(np.mean(coverages)) if coverages else 0.0
    return phase_latency, queue_wait, coverage


async def replay(
    service,
    trace: Sequence[ServeRequest],
    *,
    oracles: Optional[Dict[str, np.ndarray]] = None,
    time_scale: float = 1.0,
    integer_values: bool = False,
    dtype=np.float32,
) -> SLOReport:
    """Fire ``trace`` at ``service`` with scaled arrival timing; await all.

    Args:
      service: a started :class:`~repro_torch.serve.service.AsyncSpmvService`.
      trace: :func:`~repro_torch.serve.workload.generate_trace` output (or any
        ServeRequest sequence sorted by ``t``).
      oracles: {matrix name: dense array} — verify every completion
        against ``a @ x`` (max |err| + bit-equality count).  A torch tensor
        stays where it lies (``a @ x`` runs there); anything else becomes
        a host ndarray.  The checks run after the last request resolves,
        outside ``wall_s`` and every latency: run on the event loop between
        completions, each oracle product would delay the delivery of every
        request still in flight (on a fast device, by more than it waits
        to be served).
      time_scale: arrival-time multiplier; 1.0 replays in real time, 0.0
        fires as fast as the loop allows (keeps order, drops gaps).
      integer_values: the workload's payload mode (must match the spec the
        trace came from for oracle bit-equality to be meaningful).
      dtype: payload dtype.

    Returns:
      The :class:`SLOReport`; ``report.lost == 0`` is the zero-loss check.
    """
    loop = asyncio.get_running_loop()
    if oracles is not None:  # convert once, not per completed request
        oracles = {k: _oracle(v, dtype) for k, v in oracles.items()}
    resolved: Dict[int, str] = {}  # outcomes by trace index
    latencies: list = []
    per_tenant: Dict[str, dict] = {}
    report = SLOReport(requests=len(trace))
    reasons: Dict[str, int] = {}
    solve_latencies: list = []  # time-to-solution per completed session
    solve_iters: list = []
    solve_per_iter: list = []
    checks: list = []  # (name, x, answer, power steps or None), verified last

    def tstate(tenant: str) -> dict:
        return per_tenant.setdefault(tenant, {
            "completed": 0, "rejected": 0, "errors": 0, "vectors": 0,
            "latencies": [], "reject_reasons": {},
        })

    async def fire(i: int, req: ServeRequest, x: np.ndarray) -> None:
        ts = tstate(req.tenant)
        t0 = loop.time()
        try:
            if req.is_solve:
                result = await service.solve(
                    req.tenant, req.name, x, steps=req.solve_steps,
                    combine=req.solve_combine, deadline_s=req.deadline_s,
                )
            else:
                y = await service.multiply(
                    req.tenant, req.name, x, deadline_s=req.deadline_s
                )
        except RequestRejected as rej:
            resolved[i] = "rejected"
            ts["rejected"] += 1
            ts["reject_reasons"][rej.reason] = \
                ts["reject_reasons"].get(rej.reason, 0) + 1
            reasons[rej.reason] = reasons.get(rej.reason, 0) + 1
            if req.infeasible:
                report.infeasible_rejected += 1
            return
        except Exception:
            resolved[i] = "error"
            ts["errors"] += 1
            return
        latency = loop.time() - t0
        resolved[i] = "completed"
        ts["completed"] += 1
        ts["vectors"] += req.batch
        if req.infeasible:
            report.infeasible_served += 1
        if req.deadline_s is not None and latency > req.deadline_s:
            report.late += 1
        if req.is_solve:
            # solver sessions score on their own axis (time-to-solution,
            # iterations); folding a k-step session into the multiply
            # percentiles would drown the request-latency signal
            solve_latencies.append(latency)
            solve_iters.append(result.steps)
            solve_per_iter.append(result.per_iter_s)
            report.solves_converged += int(result.converged)
            if oracles is not None and req.name in oracles \
                    and req.solve_combine == "power":
                checks.append((req.name, x, np.asarray(result.x), result.steps))
            return
        latencies.append(latency)
        ts["latencies"].append(latency)
        if oracles is not None and req.name in oracles:
            checks.append((req.name, x, np.asarray(y), None))

    start = loop.time()
    start_mark = obs_clock()  # only spans recorded after this mark are ours
    tasks = []
    for i, req in enumerate(trace):
        if time_scale > 0:
            delay = start + req.t * time_scale - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
        else:
            await asyncio.sleep(0)  # keep arrival order, drop the gaps
        entry = service.engine.registry.get(service.resolve(req.tenant, req.name))
        x = request_vector(req, entry.shape[1], dtype=dtype,
                           integer=integer_values)
        tasks.append(asyncio.ensure_future(fire(i, req, x)))
    await asyncio.gather(*tasks)
    await service.drain()
    report.wall_s = loop.time() - start
    for name, x, got, steps in checks:
        expect = (_apply(oracles[name], x) if steps is None
                  else _np_power(oracles[name], x, steps))
        report.verified += 1
        err = float(np.max(np.abs(got - expect))) if got.size else 0.0
        report.max_abs_err = max(report.max_abs_err, err)
        if np.array_equal(got, expect):
            report.bitexact += 1

    report.completed = sum(1 for v in resolved.values() if v == "completed")
    report.rejected = sum(1 for v in resolved.values() if v == "rejected")
    report.errors = sum(1 for v in resolved.values() if v == "error")
    report.lost = len(trace) - len(resolved)
    report.reject_reasons = reasons
    report.latency = _percentiles(latencies)

    # per-SLO-class scorecard: the tenant -> class mapping comes from the
    # service's admission configs (duck-typed services without one score as
    # all-standard, which degrades to the classic single-class report)
    def tenant_class(tenant: str) -> str:
        admission = getattr(service, "admission", None)
        if admission is None:
            return "standard"
        return getattr(admission.state(tenant).config, "priority", "standard")

    classes = {t: tenant_class(t) for t in per_tenant}
    per_class: Dict[str, dict] = {}
    for tenant, ts in per_tenant.items():
        cs = per_class.setdefault(classes[tenant], {
            "tenants": 0, "completed": 0, "rejected": 0, "errors": 0,
            "vectors": 0, "latencies": [], "reject_reasons": {},
        })
        cs["tenants"] += 1
        for k in ("completed", "rejected", "errors", "vectors"):
            cs[k] += ts[k]
        cs["latencies"].extend(ts["latencies"])
        for reason, n in ts["reject_reasons"].items():
            cs["reject_reasons"][reason] = \
                cs["reject_reasons"].get(reason, 0) + n
    for cs in per_class.values():
        cs.update(_percentiles(cs.pop("latencies")))
    for tenant, ts in per_tenant.items():
        stats = _percentiles(ts.pop("latencies"))
        ts.update(stats)
        ts["class"] = classes[tenant]
    report.per_tenant = per_tenant
    report.per_class = per_class
    report.fairness_by_class, report.fairness = _class_fairness(
        {t: d["vectors"] for t, d in per_tenant.items()}, classes)
    report.solves = len(solve_latencies)
    if solve_latencies:
        report.solve_latency = _percentiles(solve_latencies)
        iters = np.asarray(solve_iters, dtype=np.float64)
        report.solve_iters = {
            "mean": float(iters.mean()),
            "p50": float(np.percentile(iters, 50)),
            "max": float(iters.max()),
        }
        report.solve_per_iter_us = float(np.mean(solve_per_iter) * 1e6)
    report.phases = _aggregate_phases(service.engine.telemetry)
    (report.phase_latency, report.queue_wait,
     report.span_coverage) = _aggregate_spans(
        getattr(service, "tracer", None), start_mark)
    return report


def replay_sync(service, trace, **kwargs) -> SLOReport:
    """One-shot convenience: start the service, replay, drain, close (over
    a world of ranks the service's close closes the engine, which releases
    the ranks that follow).

    Runs its own event loop — use from scripts/benchmarks, not from async
    code (there, ``await replay(...)`` directly).
    """

    async def _run():
        async with service:
            return await replay(service, trace, **kwargs)

    return asyncio.run(_run())
