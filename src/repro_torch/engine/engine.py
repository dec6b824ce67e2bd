"""SpmvEngine — register once, multiply many times.

Counterpart of ``repro/engine/engine.py``.  The serving layer on top of the
``repro_torch.api`` pipeline: ``register(name, a)`` runs
``SparseMatrix -> ExecutionPlan -> Executor`` a single time (stats ->
adaptive plan fitted to the device pool -> partition -> device placement ->
built partitioned program) and parks the compiled executor in a
:class:`PlanCache`; ``multiply(name, x)`` afterwards only places x, runs
the cached program — for ``impl="cuda"`` one part-axis launch of the COO
or block kernel, whatever the batch width — and assembles the rows: zero
re-partitioning, zero program rebuilds, which is what makes repeated SpMV
pay off (paper §3.1, Gómez-Luna et al. §5 on amortizing DPU transfer cost).

The engine adapts the paper plan to the device pool: the adaptive selector
is asked for a scheme as if every pool entry were a PIM core, and the
resulting grid is fitted to the divisibility constraints of the 2D schemes
(falling back to 1D element-balanced COO, which always fits) — the same
``repro_torch.api.fit_plan`` rules every other entry point uses.  As in
``plan(devices=...)``, every entry of the pool names the same device: P
entries are P parts on one card (or on the CPU), one launch serving them
all.

:meth:`SpmvEngine.solve` runs an on-device solver session
(``Executor.iterate``: x stays on the card across the steps) as one
request: one plan lookup and one Telemetry record (``kind="solve"``).

``SpmvEngine(tune=True)`` measures and refines plans off live traffic
(:mod:`repro_torch.tune`): a background thread compiles and times the
candidates on its own CUDA stream while the serving threads go on, and
swaps the cached executor when one clears the margin.
``SpmvEngine(topology=...)`` lays every plan's mesh out by the topology's
axis assignment (:mod:`repro_torch.topo`), and tunes one candidate per
assignment.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..api import AXES_2D, AXIS_1D, SparseMatrix, resolve_scheme
from ..api.executor import ExecutorReleased
from ..api.matrix import _dtype_str
from ..api.plan import IMPLS, fit_plan
from ..core.adaptive import HardwareModel, Plan
from ..core.formats import torch_dtype
from ..core.mesh import make_mesh, same_device
from ..core.streams import on_thread_stream
from ..obs import profile as obs_profile
from .plan_cache import CompiledPlan, PlanCache, PlanKey
from .registry import MatrixRegistry, RegisteredMatrix
from .telemetry import RequestRecord, Telemetry

__all__ = ["SpmvEngine"]


class SpmvEngine:
    """Batched SpMV serving over a registry of named matrices."""

    def __init__(
        self,
        devices=None,
        cache_capacity: int = 8,
        telemetry: Optional[Telemetry] = None,
        block: Tuple[int, int] = (8, 16),
        hw: Optional[HardwareModel] = None,
        impl: str = "cuda",
        tune: bool = False,
        tuner=None,
        tune_after: int = 8,
        tune_margin: float = 0.9,
        drift_factor: Optional[float] = 2.0,
        drift_alpha: float = 0.25,
        topology=None,
    ) -> None:
        """Create a serving engine over a device pool.

        Args:
          devices: the pool to serve from: one device (``"cuda"``, a
            ``torch.device``) or a list of P entries naming the same device
            (``["cuda"] * 16``: 16 parts on the card).  Default: the
            devices of ``topology``, else one part on the current CUDA
            device.  There is no CPU fallback: pass ``["cpu"]`` to serve
            from the CPU.
          cache_capacity: max compiled plans held (LRU; placed matrices pin
            device memory, so this is the engine's memory bound).
          telemetry: a shared Telemetry sink (default: a fresh one).
          block: (r, c) block shape for the block formats and matrix stats.
          hw: HardwareModel driving adaptive scheme selection.
          impl: default per-part kernel for registered matrices — "cuda"
            (the hand-written kernels; on CPU devices their plain versions)
            or "torch" (the plain oracles).  ``register(..., impl=...)``
            overrides per matrix.
          tune: measure-and-refine plans in the background off live traffic
            (:mod:`repro_torch.tune`): once a matrix has served
            ``tune_after`` vectors, candidates are measured on its most
            recent input and the cached executor is atomically swapped when
            the winner beats the incumbent by the ``tune_margin`` factor.
          tuner: a :class:`repro_torch.tune.Tuner` override (e.g. a
            persistent TuningCache, or a FakeMeasurer in tests); the
            default measures candidates of the engine's ``impl`` with
            ``Measurer(warmup=1, iters=3)``.
          tune_after: vectors a matrix must serve before refinement starts.
          tune_margin: swap only when measured best < incumbent * margin
            (guards against measurement-noise flapping).
          drift_factor: re-tune a tuned entry when the EWMA of its served
            batch widths drifts this factor away (either direction) from
            the width it was tuned at — the serving-drift trigger.  None
            disables drift re-tuning (one refinement per entry, ever).
          drift_alpha: EWMA weight for the observed batch width.
          topology: a :class:`repro_torch.topo.DeviceTopology` over the
            pool — each plan's mesh is then laid out in the device order of
            the cheapest axis assignment (``Mesh.slots``; see
            ``SparseMatrix.plan``) instead of flat order, and refinements
            measure one candidate per assignment.

        Raises:
          ValueError: for an unknown ``impl``, a ``tune_margin`` outside
            (0, 1], a ``drift_factor`` <= 1 or a ``drift_alpha`` outside
            (0, 1].
          NotImplementedError: a pool naming distinct devices (multi-card
            meshes).
          RuntimeError: a CUDA device is asked for and none is present.
        """
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}: one of {IMPLS}")
        if not 0.0 < tune_margin <= 1.0:
            raise ValueError(f"tune_margin must be in (0, 1]; got {tune_margin}")
        if drift_factor is not None and drift_factor <= 1.0:
            raise ValueError(
                f"drift_factor must be > 1 (or None to disable); "
                f"got {drift_factor}"
            )
        if not 0.0 < drift_alpha <= 1.0:
            raise ValueError(f"drift_alpha must be in (0, 1]; got {drift_alpha}")
        self.topology = topology
        if devices is None and topology is not None:
            devices = topology.flat_devices()
        if devices is None:
            devices = [torch.device("cuda")]
        elif isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = list(devices)
        # distinct devices / no card: raise now
        self.device = same_device(self.devices)
        self.impl = impl
        self.tune = tune
        self.tune_after = tune_after
        self.tune_margin = tune_margin
        self.drift_factor = drift_factor
        self.drift_alpha = drift_alpha
        self._tuner = tuner
        self.tune_events: list = []  # refinement outcomes, append-only
        self.cache = PlanCache(cache_capacity)
        self.registry = MatrixRegistry()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.block = block
        self.hw = hw if hw is not None else HardwareModel(chips=len(self.devices))
        self.partition_count = 0  # host preprocessing runs (cache misses)
        self._meshes: dict = {}
        self._swap_lock = threading.Lock()  # registry/cache swap atomicity
        self._tuning: set = set()  # names with a refinement in flight
        self._tune_threads: list = []
        # eviction spills the host-side partition to the registry entry so
        # reactivate() re-places without re-partitioning (let alone
        # rebuilding from dense)
        self.cache.on_evict = self._spill_evicted

    # ------------------------------------------------------------------ mesh

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def _mesh(self, shape: tuple, axes: tuple):
        key = (shape, axes)
        if key not in self._meshes:
            n = int(np.prod(shape))
            self._meshes[key] = make_mesh(shape, axes, self.devices[:n])
        return self._meshes[key]

    # ------------------------------------------------------------ plan fitting

    def _fit_plan(self, plan: Plan, shape: tuple, dtype) -> Plan:
        """Adapt the paper plan to the device pool (api.fit_plan rules)."""
        return fit_plan(plan, shape, self.n_devices, self.block,
                        topology=self.topology,
                        dtype_bytes=torch_dtype(dtype).itemsize)

    # -------------------------------------------------------------- building

    def _spill_evicted(self, compiled: CompiledPlan) -> None:
        """PlanCache eviction hook: keep the host-side PartitionedMatrix on
        every registry entry the evicted plan was serving, so reactivation
        replans with zero re-partitioning (the device tensors still go).
        Iterates a snapshot: register()/unregister() may mutate the registry
        from another thread while an eviction runs."""
        for entry in list(self.registry):
            if entry.cache_key == compiled.key:
                entry.spill = compiled.part

    def _build(self, sm: SparseMatrix, plan: Plan, key: PlanKey,
               impl: str, part=None, assignment=None) -> CompiledPlan:
        """Run the api chain once for ``plan`` and wrap the MeshExecutor.

        ``part`` short-circuits host partitioning with a spilled
        PartitionedMatrix (reactivation after eviction): the build then
        only re-places the matrix and rebuilds the program.  ``assignment``
        pins a measured axis assignment (tuned winners) instead of the cost
        model's pick.
        """
        t0 = time.perf_counter()
        if self.topology is not None:
            # plan() lays the mesh out by the cheapest (or the pinned) axis
            # assignment of the topology
            ep = sm.plan(scheme=plan, devices=self.devices,
                         topology=self.topology, impl=impl, block=self.block,
                         hw=self.hw, assignment=assignment)
        else:
            if plan.partitioning == "1d":
                mesh = self._mesh((plan.grid[0],), (AXIS_1D,))
            else:
                mesh = self._mesh(tuple(plan.grid), AXES_2D)
            ep = sm.plan(scheme=plan, mesh=mesh, impl=impl, block=self.block,
                         hw=self.hw)
        if part is not None:
            ep.part = part  # spilled host partition: skip re-partitioning
        else:
            self.partition_count += 1
        # label the (expensive) partition + place + build region in any
        # captured profile; a no-op while annotations are disabled
        with obs_profile.annotate(f"plan_compile:{plan.tag}:{impl}"):
            exe = ep.compile()
        return CompiledPlan(
            key=key,
            impl=impl,
            plan=plan,
            part=exe.part,
            arrays=exe.arrays,
            run=exe.program,
            mesh=exe.mesh,
            axes=tuple(exe.axes),
            x_spec=exe.x_spec,
            x_pad=exe.x_pad,
            trace_count_fn=lambda: exe.trace_count,
            build_seconds=time.perf_counter() - t0,
            assemble_meta=exe.program.meta,
            executor=exe,
        )

    # ------------------------------------------------------------ public API

    def register(
        self,
        name: str,
        a=None,
        *,
        dtype=None,
        plan: Optional[Plan] = None,
        partitioning: Optional[str] = None,
        warmup: bool = True,
        impl: Optional[str] = None,
    ) -> RegisteredMatrix:
        """Fingerprint, plan, partition, place and compile ``a`` under ``name``.

        Identical matrices (same fingerprint) registered again — under the
        same or another name — reuse the cached executable.

        Args:
          name: serving handle for :meth:`multiply`.
          a: a dense host matrix (2D ndarray or tensor), a
            :class:`~repro_torch.api.SparseMatrix`, or None to re-register
            ``name`` from the host-side SparseMatrix the registry kept (the
            spill-cache path: stats, fingerprint and containers are already
            cached, and an eviction-spilled partition additionally skips
            re-partitioning).  A SparseMatrix is the one departure from the
            JAX engine, which takes dense arrays only: at the sizes served
            on the card (tens of millions of nonzeros on a 2M x 2M matrix)
            no dense array can exist, so the matrix comes as triplets
            (``SparseMatrix.from_parts``).  It opens at the entry point the
            route the JAX engine already takes for ``a=None`` and adds no
            capability.
          dtype: optionally convert values before planning (a SparseMatrix
            is converted from its triplets, never densified).
          plan: explicit adaptive.Plan override (still fitted to the pool).
          partitioning: force "1d"/"2d" over the adaptive choice.
          warmup: run the vector-shaped program once now, off the request
            path.
          impl: per-part kernel override — "cuda" or "torch"; default is
            the engine-wide ``self.impl``.  "cuda" plans carry the kernels'
            chunk plans or block-row pointers in the cached placement, so
            the micro-batched SpMM is one part-axis launch.

        Returns:
          The RegisteredMatrix registry entry.

        Raises:
          ValueError: for a non-2D matrix, an unknown ``impl``, or ``a=None``
            without a prior registration holding the host-side matrix.
        """
        prior = self.registry.find(name)
        if a is None:
            if prior is None or prior.matrix is None:
                raise ValueError(
                    f"register({name!r}) without a matrix needs a prior "
                    "registration holding its host-side SparseMatrix"
                )
            sm = prior.matrix
        elif isinstance(a, SparseMatrix):
            sm = a
        else:
            sm = SparseMatrix.from_dense(a, dtype=dtype, stats_block=self.block)
        if dtype is not None and torch_dtype(dtype) != sm.dtype:
            sm = SparseMatrix.from_parts(*sm.triplets(dtype), sm.shape)
        impl = self.impl if impl is None else impl
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}: one of {IMPLS}")
        plan = resolve_scheme(
            sm.stats, sm.shape, self.n_devices,
            plan if plan is not None else "auto",
            hw=self.hw, partitioning=partitioning, block=self.block,
        )
        fp = sm.fingerprint()
        dtype_str = _dtype_str(sm.dtype)
        key: PlanKey = (fp, tuple(plan.grid), dtype_str, plan.tag, impl)
        with self._swap_lock:
            compiled = self.cache.get(key)
        if compiled is None:
            # an eviction-spilled partition for this exact plan identity
            # short-circuits host partitioning
            part = (prior.spill
                    if prior is not None and prior.cache_key == key else None)
            compiled = self._build(sm, plan, key, impl, part=part)
            with self._swap_lock:
                self.cache.put(compiled)
        entry = RegisteredMatrix(
            name=name,
            fingerprint=fp,
            shape=sm.shape,
            dtype=dtype_str,
            stats=sm.stats,
            plan=compiled.plan,
            cache_key=key,
            matrix=sm,  # host-side; lets reactivation re-plan
        )
        # overwriting a name must not strand the old plan in the cache
        self.registry.add(entry)
        if prior is not None and prior.cache_key != key and not any(
            e.cache_key == prior.cache_key for e in self.registry
        ):
            with self._swap_lock:
                self.cache.evict(prior.cache_key)
        if warmup:
            compiled.executor.warmup()
        return entry

    def _compiled(self, entry: RegisteredMatrix) -> CompiledPlan:
        # lock: requests on several threads touch the LRU order, and
        # OrderedDict move_to_end racing popitem corrupts it
        with self._swap_lock:
            compiled = self.cache.get(entry.cache_key)
        if compiled is None:
            raise RuntimeError(
                f"plan for {entry.name!r} was evicted from the cache; "
                f"reactivate({entry.name!r}) rebuilds it from the host-side "
                "spill (or grow cache_capacity)"
            )
        return compiled

    def _serving(self, entry: RegisteredMatrix) -> Optional[CompiledPlan]:
        """The CompiledPlan now serving ``entry`` (None if evicted), without
        touching LRU order.  Callers compare it with the plan they looked
        up by identity: a swap back to the same key installs a new one."""
        with self._swap_lock:
            return self.cache.peek(entry.cache_key)

    def reactivate(self, name: str, warmup: bool = True) -> RegisteredMatrix:
        """Rebuild the compiled plan for an evicted entry — cheaply.

        The registry keeps each entry's host-side ``SparseMatrix`` (stats,
        fingerprint, containers all cached) and, after an eviction, the
        spilled ``PartitionedMatrix``; reactivation therefore only re-places
        the partitions and rebuilds the program — no dense rebuild, no
        re-partitioning.  A no-op when the plan is still cached.

        Args:
          name: a registered matrix whose plan may have been evicted.
          warmup: run the vector-shaped program now (off the request path).

        Returns:
          The (unchanged) registry entry, its plan compiled again.

        Raises:
          KeyError: unknown ``name``.
          ValueError: the entry has no host-side matrix to rebuild from.
        """
        entry = self.registry.get(name)
        with self._swap_lock:
            if self.cache.get(entry.cache_key) is not None:
                return entry  # still live; nothing to do
        if entry.matrix is None:
            raise ValueError(
                f"{name!r} carries no host-side SparseMatrix to reactivate "
                "from; re-register it with the matrix"
            )
        built = self._build(entry.matrix, entry.plan, entry.cache_key,
                            entry.cache_key[4], part=entry.spill)
        with self._swap_lock:
            if self.cache.peek(entry.cache_key) is not None:
                built.release()  # lost a race; the cached build wins
                self.cache.get(entry.cache_key)
            else:
                self.cache.put(built)
        entry.spill = None  # the live CompiledPlan owns the partition again
        if warmup:
            self.plan_for(name).executor.warmup()
        return entry

    def multiply(self, name: str, x, *, obs=None) -> np.ndarray:
        """y = A @ x for registered ``name``.

        Serves from the cached executor: place x -> run the program ->
        assemble rows; the three phase times land in telemetry (Fig.-17
        load/kernel/retrieve split).  The request runs on the calling
        thread's own CUDA stream and each phase ends in a wait on that
        stream alone, so under concurrent requests from several host
        threads a phase time holds this request's work only.

        Under ``tune=True`` a request whose plan a refinement swapped out
        between its lookup and its launch runs again on the winner: the
        released executor launched nothing, so the caller sees one answer
        and the launch count one launch (the JAX engine raises its
        deleted-array error there).  The request also feeds the batch-width
        EWMA and may start a refinement (:meth:`refine`).

        Args:
          name: handle from :meth:`register`.
          x: (cols,) vector, or (cols, B) for a batched SpMM request (host
            ndarray or tensor).
          obs: optional :class:`repro_torch.obs.Trace` handle — or a
            sequence of them, one per rider of a coalesced batch — on which
            the three phase spans (load/kernel/retrieve) of THIS execution
            are recorded.  Riders share the batch's phase timestamps: the
            batch ran once, and that once is each rider's kernel time.

        Returns:
          Host rows (rows[, B]).

        Raises:
          KeyError: unknown ``name``.
          RuntimeError: the plan was evicted from the cache (re-register).
          TypeError/ValueError: dtype or shape mismatch with the matrix.
        """
        entry = self.registry.get(name)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        batch = x.shape[1] if x.ndim == 2 else 1

        while True:
            cp = self._compiled(entry)
            exe = cp.executor
            traces_before = cp.trace_count
            t0 = time.perf_counter()
            with obs_profile.annotate(f"spmv_load:{name}"):
                xs = exe.place(x)  # load: validate dtype/shape, pad, copy
            t1 = time.perf_counter()
            try:
                with obs_profile.annotate(f"spmv_kernel:{name}:b{batch}"):
                    raw = exe.run_raw(xs)  # kernel: one part-axis launch + merge
                break
            except ExecutorReleased:
                # released by a refinement's swap after the lookup: rerun on
                # the plan now serving the entry (each rerun needs another
                # swap, so this ends); a release without a swap (an
                # eviction) raises, and so does every other error
                current = self._serving(entry)
                if current is None or current is cp:
                    raise
        t2 = time.perf_counter()
        with obs_profile.annotate(f"spmv_retrieve:{name}"):
            y = exe.assemble(raw)  # retrieve: assemble rows, copy to host
        t3 = time.perf_counter()
        if obs is not None:
            for ctx in (obs if isinstance(obs, (list, tuple)) else (obs,)):
                ctx.add("load", t0, t1)
                ctx.add("kernel", t1, t2, batch=batch)
                ctx.add("retrieve", t2, t3)

        entry.requests += batch
        warm = cp.requests_served > 0
        cp.requests_served += 1
        self.telemetry.record(RequestRecord(
            name=name,
            batch=batch,
            load_s=t1 - t0,
            kernel_s=t2 - t1,
            retrieve_s=t3 - t2,
            cache_hit=warm,
            traced=cp.trace_count > traces_before,
        ))
        if self.tune:
            entry.batch_ewma = (
                float(batch) if entry.batch_ewma is None
                else (1.0 - self.drift_alpha) * entry.batch_ewma
                + self.drift_alpha * batch
            )
            if entry.tuned and self._batch_drifted(entry):
                # the serving batch width left the regime the last tuning
                # measured: re-qualify the entry for a background re-tune
                entry.tuned = False
            if not entry.tuned:
                self._maybe_refine(entry, x)
        return y

    def solve(
        self,
        name: str,
        x0,
        *,
        steps: Optional[int] = None,
        tol: Optional[float] = None,
        combine="plain",
        b=None,
        diag=None,
        omega: float = 1.0,
        max_steps: int = 1000,
        check_every: int = 8,
        obs=None,
    ):
        """Run an on-device solver session over registered ``name``.

        One plan lookup, one solver loop
        (:meth:`repro_torch.api.Executor.iterate` — x stays on the device
        across all SpMVs, on the calling thread's own stream), one
        Telemetry record for the whole session (``kind="solve"`` with the
        step count, so per-iteration cost is ``rec.per_iter_s``;
        :meth:`Telemetry.last` keeps reporting per-multiply times).  An
        evicted plan is reactivated transparently from the host-side spill —
        a session never fails just because the LRU rotated.  Under
        ``tune=True`` a session whose plan a refinement swapped out between
        its lookup and its loop runs on the winner, as :meth:`multiply`
        does.

        Args:
          name: handle from :meth:`register` (square matrices only).
          x0: (n,) start vector.
          steps / tol / combine / b / diag / omega / max_steps /
            check_every: forwarded to ``Executor.iterate``.
          obs: optional :class:`repro_torch.obs.Trace` — the session's
            load / kernel / retrieve spans are recorded on it (kernel is the
            whole loop; ``steps`` rides as a span attribute).

        Returns:
          :class:`repro_torch.api.IterateResult`.

        Raises:
          KeyError: unknown ``name``.
          ValueError: non-square matrix, bad steps/tol/combine params.
          TypeError: x0 dtype mismatch.
        """
        entry = self.registry.get(name)
        while True:
            try:
                cp = self._compiled(entry)
            except RuntimeError:
                # evicted mid-lifetime: rebuild from the spilled partition
                # and carry on — the session contract is one lookup, not
                # one prayer
                self.reactivate(name, warmup=False)
                cp = self._compiled(entry)
            traces_before = cp.trace_count
            t0 = time.perf_counter()
            try:
                with obs_profile.annotate(f"spmv_solve:{name}"):
                    result = cp.executor.iterate(
                        x0, steps=steps, tol=tol, combine=combine, b=b,
                        diag=diag, omega=omega, max_steps=max_steps,
                        check_every=check_every,
                    )
                break
            except ExecutorReleased:
                # swapped out by a refinement, or evicted, after the lookup
                # and before the loop took the arrays (nothing launched):
                # look up again — the winner, or the reactivated plan
                if self._serving(entry) is cp:
                    raise
        if obs is not None:
            t1 = t0 + result.load_s
            t2 = t1 + result.kernel_s
            for ctx in (obs if isinstance(obs, (list, tuple)) else (obs,)):
                ctx.add("load", t0, t1)
                ctx.add("kernel", t1, t2, steps=result.steps)
                ctx.add("retrieve", t2, t2 + result.retrieve_s)
        entry.requests += result.steps  # a session is `steps` SpMVs of traffic
        warm = cp.requests_served > 0
        cp.requests_served += 1
        self.telemetry.record(RequestRecord(
            name=name,
            batch=1,
            load_s=result.load_s,
            kernel_s=result.kernel_s,
            retrieve_s=result.retrieve_s,
            cache_hit=warm,
            traced=result.compiled or cp.trace_count > traces_before,
            kind="solve",
            steps=result.steps,
        ))
        return result

    # --------------------------------------------------- measure-and-refine

    def _make_tuner(self):
        """Default background tuner: same-impl candidates, in-memory cache."""
        if self._tuner is None:
            from ..tune import CandidateGenerator, Measurer, Tuner

            self._tuner = Tuner(
                generator=CandidateGenerator(impls=(self.impl,)),
                measurer=Measurer(warmup=1, iters=3),
            )
        return self._tuner

    def _batch_drifted(self, entry: RegisteredMatrix) -> bool:
        """Has the served batch width drifted drift_factor x away (either
        direction) from the width the entry was last tuned at?"""
        if self.drift_factor is None or entry.tuned_batch is None \
                or entry.batch_ewma is None:
            return False
        hi = max(entry.batch_ewma, entry.tuned_batch)
        lo = max(1e-9, min(entry.batch_ewma, entry.tuned_batch))
        return hi / lo >= self.drift_factor

    @staticmethod
    def _snapshot(x):
        """(copy, ready): a copy of request input ``x`` the caller cannot
        mutate, and for a card tensor the event a reader on another stream
        waits on.  The card copy is made on the caller's current stream,
        after whatever made ``x`` there; nothing waits on the host."""
        if not isinstance(x, torch.Tensor):
            return np.array(x), None
        copy = x.clone()
        if copy.device.type != "cuda":
            return copy, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(copy.device))
        return copy, ready

    def _maybe_refine(self, entry: RegisteredMatrix, x) -> None:
        """Kick one background refinement per entry once traffic qualifies."""
        if entry.tuned or entry.requests < self.tune_after \
                or entry.name in self._tuning:  # unlocked fast path
            return
        trigger = "drift" if entry.tuned_batch is not None else "traffic"
        thread = threading.Thread(
            target=self._refine_bg, args=(entry.name, trigger),
            name=f"spmv-tune-{entry.name}", daemon=True,
        )
        with self._swap_lock:
            if entry.name in self._tuning or entry.tuned:
                return
            self._tuning.add(entry.name)
            # prune+append under the lock: concurrent triggers must not
            # lose a live thread reference (drain_tuning joins these)
            self._tune_threads = [
                t for t in self._tune_threads if t.is_alive()
            ] + [thread]
        # snapshot the triggering request only — not every request in
        # flight while the (possibly long) refinement runs
        entry.last_x, entry.last_x_ready = self._snapshot(x)
        thread.start()

    def _refine_bg(self, name: str, trigger: str = "traffic") -> None:
        try:
            self.refine(name, trigger=trigger)
        except Exception as e:  # background thread: record, never propagate
            self.tune_events.append({
                "name": name, "swapped": False, "trigger": trigger,
                "error": f"{type(e).__name__}: {e}",
            })
            # one shot per entry, success or not: a persistently failing
            # refinement must not re-spawn (and re-compile every candidate)
            # on each subsequent request — which requires disarming the
            # drift trigger too, by anchoring tuned_batch at the width that
            # failed (only a NEW drift regime re-arms it, once)
            entry = self.registry.find(name)
            if entry is not None:
                entry.tuned = True
                if entry.batch_ewma is not None:
                    entry.tuned_batch = entry.batch_ewma
        finally:
            self._tuning.discard(name)

    def refine(self, name: str, x=None, trigger: str = "manual") -> dict:
        """Measure candidate plans for ``name`` and swap in a faster one.

        The incumbent plan is always among the measured candidates, so the
        decision is apples-to-apples on the same representative input: the
        most recent live vector (``entry.last_x``), or ``x`` when given, or
        the tuner's seeded synthetic input.  Candidates are compiled, timed
        and the winner built on the calling thread's own CUDA stream; each
        placement ends in a wait on that stream, so a swapped-in plan is
        ready before any request can see it.  The executor swap is atomic
        with respect to :meth:`multiply`'s plan lookup — a request resolves
        either the old plan or the new one — and the superseded plan is
        evicted (device tensors freed) unless another registered name still
        shares it.  A request already launched on the old executor holds
        its tensors until its own wait; one that looked it up but has not
        launched yet reruns on the winner (:meth:`multiply`).

        Args:
          name: a registered matrix.
          x: representative input override, (cols,) or (cols, B).
          trigger: provenance recorded on the tune event — "manual",
            "traffic" (first qualification) or "drift" (batch-width
            re-tune).

        Returns:
          The tune event dict (also appended to ``self.tune_events``):
          winner/incumbent scheme ids, measured times, the number of
          candidates measured (0 on a cache hit), whether it swapped.

        Raises:
          KeyError: unknown ``name``.
          RuntimeError: the entry carries no matrix to re-plan from.
        """
        entry = self.registry.get(name)
        if entry.matrix is None:
            raise RuntimeError(
                f"{name!r} has no host-side SparseMatrix to tune from"
            )
        ready = None
        if x is None:
            x, ready = entry.last_x, entry.last_x_ready
        batch = None
        if x is not None and getattr(x, "ndim", 1) == 2:
            batch = int(x.shape[1])
        tuner = self._make_tuner()
        with on_thread_stream(self.device):
            if ready is not None:  # the snapshot's copy, on another stream
                torch.cuda.current_stream(self.device).wait_event(ready)
            return self._refine(entry, tuner, x, batch, trigger)

    def _refine(self, entry: RegisteredMatrix, tuner, x, batch,
                trigger: str) -> dict:
        result = tuner.tune(
            entry.matrix,
            devices=self.devices,
            block=self.block,
            hw=self.hw,
            batch=batch,
            x=x,
            baseline=(entry.plan, entry.cache_key[4]),
            topology=self.topology,
        )
        best, incumbent = result.best_measurement, result.baseline
        event = {
            "name": entry.name,
            "trigger": trigger,
            "batch": batch,
            "incumbent": incumbent.scheme_id,
            "incumbent_s": incumbent.mean_s,
            "winner": best.scheme_id,
            "winner_impl": result.best.impl,
            "winner_s": best.mean_s,
            "speedup": result.speedup,
            "from_cache": result.from_cache,
            "candidates": len(result.measurements),
            "planned": result.planned,
            "swapped": False,
        }
        plan, impl = result.best.scheme, result.best.impl
        # the ExecutionPlan's scheme_id carries the axis-assignment suffix,
        # so a tuned placement of the same scheme gets its own cache slot
        key: PlanKey = (entry.fingerprint, tuple(plan.grid),
                        entry.dtype, result.best.scheme_id, impl)
        beats = best.mean_s < incumbent.mean_s * self.tune_margin
        if key != entry.cache_key and beats:
            # fast path: the winner is already compiled — swap under ONE
            # lock acquisition so the peeked plan cannot be evicted (and
            # released) between the lookup and the swap
            with self._swap_lock:
                if self.cache.peek(key) is not None:
                    self.cache.get(key)  # mark MRU: it is about to serve
                    self._swap_entry(entry, key, plan)
                    event["swapped"] = True
            if not event["swapped"]:
                built = self._build(entry.matrix, plan, key, impl,
                                    assignment=result.best.topo_assignment)
                built.executor.warmup()  # first launch off the request path
                with self._swap_lock:
                    if self.cache.peek(key) is not None:
                        built.release()  # lost a race; the cached one wins
                        self.cache.get(key)
                        self._swap_entry(entry, key, plan)
                    else:
                        # evict-old before put: net-zero occupancy when the
                        # old key was unshared (the common case); a shared
                        # old key falls back to the normal LRU capacity
                        # contract on insert
                        self._swap_entry(entry, key, plan)
                        self.cache.put(built)
                event["swapped"] = True
        entry.tuned = True
        # anchor the drift detector at the *observed width EWMA*, not the
        # width of the one representative request: under a stationary
        # mixed-width stream (ewma ~2.5, coalesced batches of 1 or 8) a
        # per-request anchor would re-trigger drift forever; only a real
        # shift of the traffic mix should re-arm _batch_drifted
        entry.tuned_batch = (entry.batch_ewma if entry.batch_ewma is not None
                             else (float(batch) if batch else 1.0))
        entry.batch_ewma = entry.tuned_batch
        self.tune_events.append(event)
        return event

    def _swap_entry(self, entry: RegisteredMatrix, key: PlanKey,
                    plan: Plan) -> None:
        """Point ``entry`` at the new compiled plan and evict its old plan
        unless another registered name still shares it — net-zero cache
        occupancy, so a background swap never pushes a *different* matrix's
        only executable out of the LRU.  Caller holds ``_swap_lock``."""
        old_key, entry.cache_key, entry.plan = entry.cache_key, key, plan
        if old_key != key and not any(
            e.cache_key == old_key for e in self.registry
        ):
            self.cache.evict(old_key)

    def drain_tuning(self, timeout: float = 30.0) -> None:
        """Block until in-flight background refinements finish (tests)."""
        for thread in list(self._tune_threads):
            thread.join(timeout)
        self._tune_threads = [t for t in self._tune_threads if t.is_alive()]

    # -------------------------------------------------------- introspection

    def trace_count(self, name: str) -> int:
        """Programs built for the plan serving ``name`` (test hook; the JAX
        package counts jit traces here)."""
        cp = self.cache.peek(self.registry.get(name).cache_key)
        return cp.trace_count if cp is not None else 0

    def plan_for(self, name: str) -> Optional[CompiledPlan]:
        """The CompiledPlan serving ``name`` (None if evicted); does not
        touch LRU order."""
        return self.cache.peek(self.registry.get(name).cache_key)

    def unregister(self, name: str) -> None:
        """Drop ``name``; evicts its compiled plan unless another registered
        name still shares it (same fingerprint/scheme/impl)."""
        entry = self.registry.remove(name)
        if entry is not None and not any(
            e.cache_key == entry.cache_key for e in self.registry
        ):
            with self._swap_lock:
                self.cache.evict(entry.cache_key)
