"""AsyncSpmvService — the asyncio, multi-tenant front door of the engine.

Counterpart of ``repro/serve/service.py``, over the port's engine.

``SpmvEngine`` serves synchronously and ``MicroBatcher`` hands back
``concurrent.futures`` futures — fine inside one process, useless to an
event-loop server.  This module is the bridge and the policy layer on top:

    service = AsyncSpmvService(engine)
    service.register("acme", "graph", a)
    async with service:
        y = await service.multiply("acme", "graph", x, deadline_s=0.05)

Every request passes the :class:`~repro_torch.serve.admission.AdmissionController`
first (bounded per-tenant pending queues, token-bucket rate limits,
deadline-based shedding against the observed service-time EWMA) and is only
then enqueued: single vectors into the engine's deadline-aware
``MicroBatcher`` (so concurrent awaits coalesce into one SpMM — the paper's
amortize-the-matrix-traffic rule applied to serving), explicit ``(cols, B)``
batches straight onto a worker thread.  The returned future is bridged onto
the event loop with ``asyncio.wrap_future``; the loop thread never runs a
kernel: requests reach the card from the batcher's flush thread and the
worker pool, concurrently, each thread on its own CUDA stream.
``await solve(tenant, name, x0, steps=k | tol=...)`` runs an on-device
solver session on a worker thread as one admitted request.

Rejected requests raise :class:`~repro_torch.serve.admission.RequestRejected`
*immediately* — load shedding means the caller finds out now, not after the
deadline has burned down in a queue.  ``drain()`` flushes and awaits all
in-flight work; ``aclose()`` (or ``async with``) drains and then rejects
further traffic with reason ``shutdown``.

Observability (:mod:`repro_torch.obs`): the service owns a ring-buffered
``Tracer`` and a ``MetricsRegistry``.  Every request gets a lifecycle trace
— ``admit -> queue_wait -> batch_form -> load -> kernel -> retrieve ->
deliver`` — threaded through the batcher into the engine, and the admission
controller sheds on *queue-aware* expected completion (queued vectors ahead
x the service-time EWMA, reason ``queue_wait_infeasible``), not bare
service time.  ``tracer=Tracer(enabled=False)`` turns tracing into a
zero-allocation no-op.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from ..engine import MicroBatcher, SpmvEngine
from ..obs import MetricsRegistry, Tracer
from ..obs.tracing import clock as obs_clock

from .admission import (
    AdmissionController,
    RequestRejected,
    TenantConfig,
    class_rank,
    default_deadline,
)

__all__ = ["AsyncSpmvService"]


class AsyncSpmvService:
    """Asyncio multi-tenant SpMV serving over one :class:`SpmvEngine`.

    The service is the policy layer between callers and the engine: every
    request is admitted first (per-tenant budgets + deadline feasibility),
    then coalesced (single vectors through the priority-aware
    :class:`MicroBatcher`, explicit batches onto worker threads), and
    finally delivered back onto the event loop.  A tenant's SLO class
    (:attr:`TenantConfig.priority`) decides its batch-formation priority
    and its class-aware queue-wait admission depth — see docs/slo.md.
    """

    def __init__(
        self,
        engine: Optional[SpmvEngine] = None,
        *,
        batcher: Optional[MicroBatcher] = None,
        admission: Optional[AdmissionController] = None,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        safety: float = 1.0,
        est_alpha: float = 0.3,
        max_batch: int = 8,
        buckets=(1, 2, 4, 8),
        max_delay_s: float = 0.002,
        promote_after_s: float = 0.25,
        workers: int = 2,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        """Build the service (does not start the flush thread; see
        :meth:`start` / ``async with``).

        Args:
          engine: the serving engine (default: a fresh ``SpmvEngine()``).
          batcher: a MicroBatcher override; the default is auto_flush=False
            — full queues are flushed from worker threads and deadlines from
            the batcher's background thread, so the event loop never blocks
            on an SpMM.
          admission: an AdmissionController override (brings its own
            default TenantConfig / safety).
          tenants: {tenant: TenantConfig} installed up front; unknown
            tenants get the controller's default config on first request.
          safety: deadline-feasibility margin for the default controller
            (reject when deadline < estimate * safety).
          est_alpha: EWMA weight for the observed per-matrix service time
            (the estimate feasibility shedding compares deadlines against).
          max_batch/buckets/max_delay_s: MicroBatcher knobs for the default
            batcher (coalescing width, padded batch shapes, default flush
            deadline).
          promote_after_s: the default batcher's starvation guard — a
            queued request's effective SLO class improves by one step per
            ``promote_after_s`` seconds waited (docs/slo.md).
          workers: thread-pool width for explicit-batch requests and
            queue-full flushes.
          tracer: request-lifecycle span sink (default: an enabled
            ring-buffered ``Tracer()``; pass ``Tracer(enabled=False)`` for
            a zero-overhead no-op).
          metrics: the service's ``MetricsRegistry`` (default: a fresh
            one), shared with the default batcher and admission controller.

        Raises:
          ValueError: for est_alpha outside (0, 1].
        """
        if not 0.0 < est_alpha <= 1.0:
            raise ValueError(f"est_alpha must be in (0, 1]; got {est_alpha}")
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.engine = engine if engine is not None else SpmvEngine()
        self.batcher = batcher if batcher is not None else MicroBatcher(
            self.engine, max_batch=max_batch, buckets=buckets,
            auto_flush=False, max_delay_s=max_delay_s,
            promote_after_s=promote_after_s, metrics=self.metrics,
        )
        self.admission = admission if admission is not None else \
            AdmissionController(safety=safety, metrics=self.metrics)
        if tenants:
            for tenant, config in tenants.items():
                self.admission.configure(tenant, config)
        self.est_alpha = est_alpha
        self._est: Dict[str, float] = {}  # scoped name -> service-time EWMA
        self._solve_est: Dict[str, float] = {}  # scoped name -> per-iter EWMA
        self._tenant_names: Dict[str, set] = {}  # tenant -> scoped names
        self._inflight: set = set()  # asyncio futures awaiting backend work
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="spmv-serve"
        )
        self._closed = False
        self._started = False
        self.served = 0  # requests answered successfully
        self.errors = 0  # admitted requests that failed in the backend

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "AsyncSpmvService":
        """Start the batcher's deadline-flush thread (idempotent)."""
        self.batcher.start()
        self._started = True
        return self

    async def __aenter__(self) -> "AsyncSpmvService":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def drain(self) -> None:
        """Flush queued work and await every in-flight request.

        Returns once all requests admitted *before* the call have resolved
        (successfully or not); concurrent new submissions may keep the
        service busy afterwards.
        """
        loop = asyncio.get_running_loop()
        # bounded: each pass flushes + awaits the snapshot taken this pass
        for _ in range(64):
            if self.batcher.pending():
                await loop.run_in_executor(None, self.batcher.flush)
            pending = list(self._inflight)
            if not pending and not self.batcher.pending():
                return
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            else:
                await asyncio.sleep(0)
        raise RuntimeError("drain did not converge: requests keep arriving")

    async def aclose(self) -> None:
        """Drain, stop the flush thread and reject further traffic.  An
        engine over a world of ranks (``SpmvEngine(world=)``) is closed
        too: the service's lifetime bounds the other ranks' ``follow()``."""
        if self._closed:
            return
        self._closed = True
        await self.drain()
        loop = asyncio.get_running_loop()
        if self._started:
            await loop.run_in_executor(None, self.batcher.stop)
            self._started = False
        self._pool.shutdown(wait=False)
        if getattr(self.engine, "world", None) is not None:
            await loop.run_in_executor(None, self.engine.close)

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------ tenancy

    @staticmethod
    def scoped(tenant: Optional[str], name: str) -> str:
        """The engine-registry name a tenant's matrix is filed under."""
        return name if tenant is None else f"{tenant}:{name}"

    def register(self, tenant: Optional[str], name: str, a=None,
                 **register_kwargs):
        """Register ``a`` for ``tenant`` under ``name``.

        Tenants share one engine and one plan cache, so two tenants
        registering the *same* matrix (same fingerprint) share one compiled
        executable — tenancy isolates admission, not memory.  ``tenant=None``
        registers a global matrix any tenant may multiply against.  ``a=None``
        re-activates a previously registered matrix from the engine's
        host-side spill (see :meth:`SpmvEngine.register`).

        Returns:
          The engine's RegisteredMatrix entry.
        """
        scoped = self.scoped(tenant, name)
        entry = self.engine.register(scoped, a, **register_kwargs)
        if tenant is not None:
            self._tenant_names.setdefault(tenant, set()).add(scoped)
        return entry

    def resolve(self, tenant: str, name: str) -> str:
        """Tenant-scoped name when registered, else the global name."""
        scoped = self.scoped(tenant, name)
        if scoped in self.engine.registry:
            return scoped
        if name in self.engine.registry:
            return name
        raise KeyError(
            f"matrix {name!r} is registered neither for tenant {tenant!r} "
            f"nor globally"
        )

    # ------------------------------------------------------------ serving

    async def multiply(
        self,
        tenant: str,
        name: str,
        x,
        *,
        deadline_s: Optional[float] = None,
    ) -> np.ndarray:
        """y = A @ x for ``tenant``'s matrix ``name`` — admission first.

        Args:
          tenant: tenant identity (admission budgets apply per tenant).
          x: (cols,) vector — coalesced with concurrent requests into one
            SpMM by the micro-batcher — or an explicit (cols, B) batch,
            served as one request on a worker thread.
          deadline_s: SLO latency budget.  Drives both load shedding (the
            request is rejected up front when the budget cannot be met) and
            the batcher's flush deadline (the coalescing wait never eats
            the whole budget).  ``None`` falls back to the tenant class's
            default budget (``batch`` gets a loose one; interactive
            classes stay unbounded) — see docs/slo.md.

        Returns:
          Host rows (rows[, B]).

        Raises:
          RequestRejected: the admission controller refused the request
            (``.reason`` in REJECT_REASONS — including the queue-aware
            ``queue_wait_infeasible`` under backlog) or the service is
            closed.
          KeyError: unknown matrix name for this tenant.
          TypeError/ValueError: dtype/shape mismatch with the matrix.
        """
        t_start = obs_clock()
        if self._closed:
            self.admission.reject_all(tenant, "shutdown")
            raise RequestRejected(tenant, "shutdown", "service is closed")
        if not self._started:
            # lazy start: without the deadline-flush thread a sub-max_batch
            # queue would never flush and this await would hang forever
            self.start()
        rname = self.resolve(tenant, name)
        entry = self.engine.registry.get(rname)
        x = np.asarray(x)
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be (cols,) or (cols, B); got {x.shape}")
        if x.shape[0] != entry.shape[1]:
            raise ValueError(
                f"x has {x.shape[0]} rows, matrix {name!r} has "
                f"{entry.shape[1]} cols"
            )
        vectors = x.shape[1] if x.ndim == 2 else 1
        estimate = self._est.get(rname)
        cls = self.admission.state(tenant).config.priority
        rank = class_rank(cls)
        if deadline_s is None:
            # class default (batch: loose, interactive: none) so queue-wait
            # shedding has a budget to compare against even when the caller
            # stated no SLO — see docs/slo.md
            deadline_s = default_deadline(cls)
        # class-aware queue depth: only equal-or-higher-priority vectors
        # wait ahead of this tenant's class (lower ones will be preempted
        # behind it); drives the controller's wait+service feasibility model
        depth = self.batcher.pending_ahead(rname, rank) \
            if hasattr(self.batcher, "pending_ahead") \
            else self.batcher.pending(rname)
        trace = self.tracer.trace(f"{tenant}/{name}")
        ctx = trace if trace.enabled else None
        try:
            self.admission.admit(
                tenant, vectors=vectors, deadline_s=deadline_s,
                estimate_s=estimate, queue_depth=depth,
            )
        except RequestRejected as rej:
            if ctx is not None:
                ctx.add("admit", t_start, obs_clock(), outcome=rej.reason,
                        queue_depth=depth, cls=cls)
            raise
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            t_admitted = obs_clock()
            if ctx is not None:
                ctx.add("admit", t_start, t_admitted, outcome="admitted",
                        queue_depth=depth, vectors=vectors, cls=cls)
            if x.ndim == 2:
                # explicit batch: the wait for a worker thread is this
                # request's queue time
                def run_explicit():
                    t_run = obs_clock()
                    if ctx is not None:
                        ctx.add("queue_wait", t_admitted, t_run)
                    return self.engine.multiply(rname, x, obs=ctx)

                backend = self._pool.submit(run_explicit)
            else:
                backend = self.batcher.submit(
                    rname, x,
                    deadline_s=self._flush_budget(deadline_s, estimate),
                    ctx=ctx, priority=rank, cls=cls,
                )
                if self.batcher.pending(rname) >= self.batcher.max_batch:
                    # full queue: flush from a worker, never the event loop
                    self._pool.submit(self.batcher.flush, rname)
            future = asyncio.wrap_future(backend, loop=loop)
            self._inflight.add(future)
            future.add_done_callback(self._inflight.discard)
            try:
                y = await future
            except Exception:
                self.errors += 1
                raise
            t_end = obs_clock()
            if ctx is not None:
                # deliver: backend done -> this coroutine resumed with the
                # result; tiles the trace out to the caller-visible end
                ctx.add("deliver",
                        ctx.last_end if ctx.last_end is not None else t_end,
                        t_end)
            self._observe(rname, loop.time() - t0)
            self._record_metrics(rname, t_end - t_start, cls=cls)
            self.served += 1
            return y
        finally:
            self.admission.finished(tenant)

    async def solve(
        self,
        tenant: str,
        name: str,
        x0,
        *,
        steps: Optional[int] = None,
        tol: Optional[float] = None,
        combine="plain",
        deadline_s: Optional[float] = None,
        **iterate_kwargs,
    ):
        """Run an on-device solver session for ``tenant`` — one admission.

        A session of k SpMV steps is *one* request to the admission
        controller (one pending slot, one token), not k: the whole point of
        :meth:`SpmvEngine.solve` is that the iterations amortize one
        admission and one plan lookup.  Deadline feasibility is checked
        against ``steps x per-iteration EWMA`` (observed from previous
        sessions on this matrix; tol-mode sessions budget ``max_steps``),
        so an infeasible 500-step session is shed up front, before burning
        its budget on device.  The session runs on a worker thread, on that
        thread's own CUDA stream.

        Args:
          tenant: tenant identity (admission budgets apply per tenant).
          name: matrix name (square); resolved tenant-scoped then global.
          x0: (n,) start vector.
          steps / tol / combine: forwarded to the engine
            (:meth:`SpmvEngine.solve`), as are ``iterate_kwargs``
            (``b`` / ``diag`` / ``omega`` / ``max_steps`` /
            ``check_every``).
          deadline_s: SLO budget for the *whole* session.  ``None`` falls
            back to the tenant class's default budget (see docs/slo.md).

        Returns:
          :class:`repro_torch.api.IterateResult`.

        Raises:
          RequestRejected: admission refused the session (``.reason`` in
            REJECT_REASONS) or the service is closed.
          KeyError / TypeError / ValueError: as :meth:`SpmvEngine.solve`.
        """
        t_start = obs_clock()
        if self._closed:
            self.admission.reject_all(tenant, "shutdown")
            raise RequestRejected(tenant, "shutdown", "service is closed")
        if not self._started:
            self.start()
        rname = self.resolve(tenant, name)
        entry = self.engine.registry.get(rname)
        x0 = np.asarray(x0)
        if x0.ndim != 1 or x0.shape[0] != entry.shape[1]:
            raise ValueError(
                f"x0 must be ({entry.shape[1]},) for matrix {name!r}; "
                f"got shape {x0.shape}"
            )
        steps_budget = steps if steps is not None else \
            int(iterate_kwargs.get("max_steps", 1000))
        per_iter = self._solve_est.get(rname)
        estimate = None if per_iter is None else per_iter * steps_budget
        cls = self.admission.state(tenant).config.priority
        if deadline_s is None:
            deadline_s = default_deadline(cls)
        trace = self.tracer.trace(f"{tenant}/{name}:solve")
        ctx = trace if trace.enabled else None
        try:
            self.admission.admit(
                tenant, vectors=1, deadline_s=deadline_s,
                estimate_s=estimate, queue_depth=0,
            )
        except RequestRejected as rej:
            if ctx is not None:
                ctx.add("admit", t_start, obs_clock(), outcome=rej.reason,
                        steps=steps_budget, cls=cls)
            raise
        loop = asyncio.get_running_loop()
        try:
            t_admitted = obs_clock()
            if ctx is not None:
                ctx.add("admit", t_start, t_admitted, outcome="admitted",
                        steps=steps_budget, cls=cls)

            def run_solve():
                t_run = obs_clock()
                if ctx is not None:
                    ctx.add("queue_wait", t_admitted, t_run)
                return self.engine.solve(
                    rname, x0, steps=steps, tol=tol, combine=combine,
                    obs=ctx, **iterate_kwargs,
                )

            future = asyncio.wrap_future(self._pool.submit(run_solve),
                                         loop=loop)
            self._inflight.add(future)
            future.add_done_callback(self._inflight.discard)
            try:
                result = await future
            except Exception:
                self.errors += 1
                raise
            t_end = obs_clock()
            if ctx is not None:
                ctx.add("deliver",
                        ctx.last_end if ctx.last_end is not None else t_end,
                        t_end)
            self._observe_solve(rname)
            self.metrics.histogram("serve.solve.e2e_ms").observe(
                (t_end - t_start) * 1e3)
            self.metrics.histogram("serve.solve.e2e_ms", cls=cls).observe(
                (t_end - t_start) * 1e3)
            self.metrics.histogram("serve.solve.per_iter_us").observe(
                result.per_iter_s * 1e6)
            self.served += 1
            return result
        finally:
            self.admission.finished(tenant)

    def _flush_budget(self, deadline_s: Optional[float],
                      estimate_s: Optional[float]) -> Optional[float]:
        """How long the batcher may hold this request for coalescing.

        A deadline only ever *shortens* the wait below the batcher's
        ``max_delay_s`` default — when the budget is tight, flush early
        enough (deadline minus the expected service time) that the request
        can still make it; a generous SLO must not park an idle queue.
        """
        if deadline_s is None:
            return None  # the batcher's own max_delay_s default
        wait = (deadline_s / 2.0 if estimate_s is None
                else deadline_s - estimate_s)
        return max(1e-4, min(wait, deadline_s, self.batcher.max_delay_s))

    def _observe(self, rname: str, latency_s: float) -> None:
        """Fold one served request into the service-time estimate.

        The estimate drives deadline shedding, so it must be the *service*
        time (the engine's load+kernel+retrieve for the batch that carried
        this request), not the end-to-end latency — queueing and the
        coalescing wait would otherwise inflate it until feasible requests
        get shed.  Requests that (re)traced are skipped as compile
        outliers; ``latency_s`` is only the fallback when telemetry has
        nothing for this matrix.
        """
        sample = latency_s
        rec = self.engine.telemetry.last(rname)
        if rec is not None:
            if rec.traced:
                return  # compile outlier: not representative
            sample = rec.total_s
        old = self._est.get(rname)
        self._est[rname] = (sample if old is None else
                            self.est_alpha * sample
                            + (1.0 - self.est_alpha) * old)

    def _observe_solve(self, rname: str) -> None:
        """Fold one finished solve session into the per-iteration EWMA.

        Reads :meth:`Telemetry.last_solve` — never :meth:`Telemetry.last`,
        which stays per-multiply (solve sessions must not inflate the
        multiply shedding estimate, and vice versa).  Sessions that
        built their loop are skipped as cold-start outliers.
        """
        rec = self.engine.telemetry.last_solve(rname)
        if rec is None or rec.traced:
            return
        sample = rec.per_iter_s
        old = self._solve_est.get(rname)
        self._solve_est[rname] = (sample if old is None else
                                  self.est_alpha * sample
                                  + (1.0 - self.est_alpha) * old)

    def _record_metrics(self, rname: str, e2e_s: float,
                        cls: str = "standard") -> None:
        """Fold one completed request into the metrics registry.

        Per-phase series come from the engine telemetry record of the batch
        that served this request (riders of one coalesced batch observe the
        same batch-level phase times — that once IS each rider's kernel
        time); cache hit/miss gauges mirror the engine's PlanCache stats.
        End-to-end latency is recorded twice: the classless series and a
        ``cls``-labeled twin (the per-class SLO scorecard).
        """
        m = self.metrics
        m.histogram("serve.latency.e2e_ms").observe(e2e_s * 1e3)
        m.histogram("serve.latency.e2e_ms", cls=cls).observe(e2e_s * 1e3)
        rec = self.engine.telemetry.last(rname)
        if rec is not None:
            m.histogram("serve.phase.load_ms").observe(rec.load_s * 1e3)
            m.histogram("serve.phase.kernel_ms").observe(rec.kernel_s * 1e3)
            m.histogram("serve.phase.retrieve_ms").observe(
                rec.retrieve_s * 1e3)
        st = self.engine.cache.stats
        m.gauge("engine.plan_cache.hits").set(st.hits)
        m.gauge("engine.plan_cache.misses").set(st.misses)
        m.gauge("engine.plan_cache.evictions").set(st.evictions)

    def estimate(self, tenant: Optional[str], name: str) -> Optional[float]:
        """The observed service-time EWMA shedding compares deadlines to."""
        try:
            return self._est.get(self.resolve(tenant, name))
        except KeyError:
            return None

    # ------------------------------------------------------------ reporting

    def stats(self) -> dict:
        """Service-level counters + per-tenant admission snapshot."""
        out = {
            "served": self.served,
            "errors": self.errors,
            "inflight": len(self._inflight),
            "queued": self.batcher.pending(),
            "batches_run": self.batcher.batches_run,
            "vectors_run": self.batcher.vectors_run,
            "tenants": self.admission.snapshot(),
            "metrics": self.metrics.snapshot(),
        }
        if hasattr(self.batcher, "pending_by_class"):
            out["queued_by_class"] = self.batcher.pending_by_class()
            out["preemptions"] = self.batcher.preemptions
            out["promotions"] = self.batcher.promotions
        return out
