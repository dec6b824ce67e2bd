"""Micro-batching of concurrent SpMV requests into SpMM calls.

Counterpart of ``repro/engine/batcher.py``.  Single-vector SpMV is
memory-bound: the matrix traffic (values + indices) dominates and is paid
once per call.  Coalescing B concurrent right-hand sides into one (cols, B)
SpMM reuses that traffic across the batch — on the H100 one launch of the
COO or block kernel serves the whole batch — the GPU analogue of the
paper's point that PIM SpMV wins only when data movement is amortized.
The batcher therefore:

  * queues ``submit(name, x)`` requests per matrix, each carrying a flush
    *deadline* (``deadline_s`` from submission, default ``max_delay_s``),
  * flushes a matrix's queue as one ``engine.multiply(name, X)`` with X
    stacked column-wise, when the queue reaches ``max_batch``, on explicit
    ``flush()``, or — in background mode — exactly when the oldest pending
    request's deadline would otherwise be missed (the flush thread sleeps
    until the earliest deadline, not on a fixed polling interval, so an
    urgent request is never stuck behind a timer and an idle batcher burns
    no wakeups),
  * pads the batch up to the next size in ``buckets`` so the kernels see a
    bounded set of batch widths (on the H100 the block kernel's route
    follows the width: CUDA cores at B = 2 and 4, tensor cores at B = 8).

**SLO classes** (docs/slo.md): each submit carries a ``priority`` rank
(0 = most urgent; the serving layer maps ``rt``/``standard``/``batch``
tenants onto 0/1/2).  The per-matrix queue is a priority queue at *claim*
time: when a flush pops a queue, the popped requests are sorted by
``(effective rank, arrival)`` before being chunked into ``max_batch``-wide
SpMMs, so an ``rt`` arrival preempts a forming low-priority batch — it
rides the first chunk while the bulk work slides into later ones.  A
**starvation guard** bounds the preemption: a queued request's effective
rank improves by one class for every ``promote_after_s`` seconds it has
waited, so an aged ``batch`` request eventually outranks a stream of fresh
``rt`` arrivals.  ``pending_ahead(name, rank)`` exposes the class-aware
queue depth (vectors at equal-or-higher priority) that the admission
controller's queue-wait model consumes.

Results are delivered through ``concurrent.futures.Future``s so callers can
block, poll or chain.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["MicroBatcher"]


#: Priority rank a submit gets when none is given ("standard" traffic).
DEFAULT_RANK = 1


@dataclass
class _Pending:
    x: np.ndarray
    future: Future
    deadline: float  # monotonic time by which this request must flush
    ctx: object = None  # repro_torch.obs Trace handle (or None / NULL_TRACE)
    t_submit: float = 0.0  # perf_counter at enqueue (queue_wait span start)
    rank: int = DEFAULT_RANK  # SLO class rank; 0 is most urgent
    cls: str = "standard"  # class label (metrics only; rank decides order)
    seq: int = 0  # arrival order, the tie-break within a rank
    t_enqueue: float = 0.0  # monotonic at enqueue (starvation-guard age)


class MicroBatcher:
    """Deadline-aware, priority-aware coalescing of SpMV submits into SpMM.

    One instance fronts one engine.  ``submit`` enqueues per matrix;
    flushes happen on a full queue, an explicit :meth:`flush`, or — in
    background mode — when the earliest pending deadline arrives.  Popped
    requests are served highest-priority-first (see the module docstring
    for the preemption and starvation-guard rules).

    Args:
      engine: the owning :class:`SpmvEngine` (or a duck-typed stand-in
        exposing ``registry.get`` and ``multiply``).
      max_batch: widest SpMM chunk a flush serves at once.
      buckets: padded batch widths the kernels may see.
      auto_flush: flush synchronously from ``submit`` when a queue fills
        (the serving layer disables this and flushes from worker threads).
      max_delay_s: default flush deadline for submits without one.
      promote_after_s: starvation guard — a queued request's effective
        rank improves by one class per ``promote_after_s`` seconds waited.
      metrics: optional :class:`repro_torch.obs.MetricsRegistry` — queue-depth
        gauges (total and per class), batch-width histogram, preemption
        and promotion counters land here.
    """

    def __init__(
        self,
        engine,
        max_batch: int = 8,
        buckets: Sequence[int] = (1, 2, 4, 8),
        auto_flush: bool = True,
        max_delay_s: float = 0.002,
        promote_after_s: float = 0.25,
        metrics=None,
    ) -> None:
        if max_batch > max(buckets):
            raise ValueError("max_batch must be <= the largest bucket")
        if promote_after_s <= 0:
            raise ValueError(
                f"promote_after_s must be > 0, got {promote_after_s}")
        self.engine = engine
        self.max_batch = max_batch
        self.buckets = tuple(sorted(buckets))
        self.auto_flush = auto_flush
        self.max_delay_s = max_delay_s
        self.promote_after_s = promote_after_s
        # optional repro_torch.obs.MetricsRegistry: queue-depth gauge + batch-width
        # histogram land here when the serving layer provides one
        self.metrics = metrics
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues: Dict[str, List[_Pending]] = defaultdict(list)
        self._seq = 0  # global arrival counter (FIFO tie-break within rank)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.batches_run = 0
        self.vectors_run = 0
        self.deadline_flushes = 0  # background flushes triggered by a deadline
        self.preemptions = 0  # flush chunks reordered by priority
        self.promotions = 0  # aged requests served above their nominal rank

    # ------------------------------------------------------------- requests

    def submit(self, name: str, x, deadline_s: Optional[float] = None,
               ctx=None, priority: Optional[int] = None,
               cls: str = "standard") -> Future:
        """Enqueue one SpMV; returns a Future resolving to y (rows,).

        ``deadline_s`` is this request's latency budget: in background mode
        its queue is flushed no later than ``deadline_s`` after submission
        (default ``max_delay_s``).

        ``ctx`` is an optional :class:`repro_torch.obs.Trace` handle: the batcher
        stamps ``queue_wait`` (enqueue -> batch claimed) and ``batch_form``
        (claim -> stacked) spans on it, and the engine continues with the
        load/kernel/retrieve phases of the coalesced batch.

        ``priority`` is the SLO class rank (0 = most urgent; default
        :data:`DEFAULT_RANK`): lower ranks are served in earlier chunks
        when the queue flushes, subject to the starvation guard.  ``cls``
        is the matching class label, used for the per-class queue-depth
        gauge only.

        A failed flush (the executor raising under the coalesced batch)
        rejects the pending futures with that exception — a submitted
        request always resolves, it never hangs.
        """
        entry = self.engine.registry.get(name)  # fail fast on unknown names
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError("submit takes a single vector; use engine.multiply"
                             " for explicit batches")
        if x.shape[0] != entry.shape[1]:
            raise ValueError(
                f"x has {x.shape[0]} rows, matrix {name!r} has "
                f"{entry.shape[1]} cols"
            )
        budget = self.max_delay_s if deadline_s is None else deadline_s
        rank = DEFAULT_RANK if priority is None else int(priority)
        fut: Future = Future()
        now = time.monotonic()
        with self._cv:
            self._seq += 1
            self._queues[name].append(_Pending(
                x, fut, now + budget,
                ctx=ctx, t_submit=time.perf_counter(),
                rank=rank, cls=cls, seq=self._seq, t_enqueue=now,
            ))
            depth = len(self._queues[name])
            cls_depth = sum(1 for p in self._queues[name] if p.cls == cls)
            full = depth >= self.max_batch
            # wake the flush thread: the earliest deadline may have moved up
            self._cv.notify_all()
        if self.metrics is not None:
            self.metrics.gauge("serve.queue.depth", matrix=name).set(depth)
            self.metrics.gauge("serve.queue.depth", matrix=name,
                               cls=cls).set(cls_depth)
        if full and self.auto_flush:
            self.flush(name)
        return fut

    def pending(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is not None:
                return len(self._queues.get(name, ()))
            return sum(len(q) for q in self._queues.values())

    def _effective_rank(self, p: _Pending, now: float) -> int:
        """The starvation-guarded rank: one class better per
        ``promote_after_s`` seconds this request has already waited."""
        waited = max(0.0, now - p.t_enqueue)
        return p.rank - int(waited / self.promote_after_s)

    def pending_ahead(self, name: str, rank: int) -> int:
        """Queued vectors a new submit at ``rank`` would wait behind.

        Counts only entries whose (starvation-guarded) effective rank is
        equal or better — lower-priority entries will be preempted behind
        the new arrival, so they do not contribute to its expected wait.
        This is the class-aware queue depth the admission controller's
        ``queue_wait_infeasible`` model consumes.
        """
        now = time.monotonic()
        with self._lock:
            return sum(1 for p in self._queues.get(name, ())
                       if self._effective_rank(p, now) <= rank)

    def pending_by_class(self, name: Optional[str] = None) -> Dict[str, int]:
        """{class label: queued vectors}, one queue or all of them."""
        with self._lock:
            queues = ([self._queues.get(name, ())] if name is not None
                      else list(self._queues.values()))
            out: Dict[str, int] = {}
            for q in queues:
                for p in q:
                    out[p.cls] = out.get(p.cls, 0) + 1
            return out

    # -------------------------------------------------------------- flushing

    def _bucket(self, b: int) -> int:
        for size in self.buckets:
            if size >= b:
                return size
        return self.buckets[-1]

    def flush(self, name: Optional[str] = None) -> int:
        """Run queued requests now; returns the number of vectors served."""
        with self._lock:
            names = [name] if name is not None else list(self._queues)
            taken = {n: self._queues.pop(n, []) for n in names}
        return self._run_taken(taken)

    def _order_claimed(self, reqs: List[_Pending]) -> List[_Pending]:
        """Priority order for one popped queue: (effective rank, arrival).

        This sort IS the preemption: a late-arriving ``rt`` request rides
        the first ``max_batch`` chunk while the bulk work it displaced
        slides into later chunks of the same flush.  The starvation guard
        bounds it — an aged request's effective rank has improved, so old
        ``batch`` work eventually sorts ahead of fresh ``rt`` arrivals.
        """
        now = time.monotonic()
        eff = {p.seq: self._effective_rank(p, now) for p in reqs}
        ordered = sorted(reqs, key=lambda p: (eff[p.seq], p.seq))
        promoted = sum(1 for p in reqs if eff[p.seq] < p.rank)
        if promoted:
            with self._lock:
                self.promotions += promoted
            if self.metrics is not None:
                self.metrics.counter("serve.promotions").inc(promoted)
        if any(a.seq != b.seq for a, b in zip(ordered, reqs)):
            with self._lock:
                self.preemptions += 1
            if self.metrics is not None:
                self.metrics.counter("serve.preemptions").inc()
        return ordered

    def _run_taken(self, taken: Dict[str, List[_Pending]]) -> int:
        served = 0
        if self.metrics is not None:
            for n, reqs in taken.items():  # these queues were just popped
                self.metrics.gauge("serve.queue.depth", matrix=n).set(0)
                for c in {p.cls for p in reqs}:
                    self.metrics.gauge("serve.queue.depth", matrix=n,
                                       cls=c).set(0)
        for n, reqs in taken.items():
            reqs = self._order_claimed(reqs)
            while reqs:
                chunk, reqs = reqs[: self.max_batch], reqs[self.max_batch:]
                self._run_batch(n, chunk)
                served += len(chunk)
        return served

    def _run_batch(self, name: str, reqs: List[_Pending]) -> None:
        """Serve one popped chunk; a popped future ALWAYS resolves.

        Every failure mode — the coalesced ``engine.multiply`` raising (an
        evicted plan, a dtype mismatch), the stacking, even result
        distribution — lands in the waiters' futures as an exception: a
        failed flush rejects its requests instead of hanging them, and the
        failure can never escape into (and kill) the background flush
        thread.
        """
        try:
            t_claim = time.perf_counter()
            # claim the futures up front; drop waiters that cancelled
            live = [p for p in reqs if p.future.set_running_or_notify_cancel()]
            if not live:
                return
            for p in live:  # queue_wait: enqueue -> this batch claimed it
                if p.ctx is not None:
                    p.ctx.add("queue_wait", p.t_submit, t_claim)
            xs = [p.x for p in live]
            b = len(xs)
            padded = self._bucket(b)
            X = np.stack(xs + [np.zeros_like(xs[0])] * (padded - b), axis=1)
            t_stack = time.perf_counter()
            for p in live:  # batch_form: stacking + bucket padding
                if p.ctx is not None:
                    p.ctx.add("batch_form", t_claim, t_stack,
                              width=b, padded=padded)
            obs = [p.ctx for p in live if p.ctx is not None]
            # only pass obs when someone is tracing: duck-typed engine
            # stand-ins (tests, mocks) need not grow the kwarg
            Y = (self.engine.multiply(name, X, obs=obs) if obs
                 else self.engine.multiply(name, X))
            with self._lock:  # flushes run on several threads at once
                self.batches_run += 1
                self.vectors_run += b
            if self.metrics is not None:
                self.metrics.histogram("serve.batch.width").observe(b)
            for j, p in enumerate(live):
                p.future.set_result(np.asarray(Y[:, j]))
        except Exception as exc:  # deliver the failure to every open waiter
            for p in reqs:
                if not p.future.done():
                    p.future.set_exception(exc)

    # ------------------------------------------------------- background mode

    def _earliest_deadline_locked(self) -> Optional[float]:
        deadlines = [p.deadline for q in self._queues.values() for p in q]
        return min(deadlines) if deadlines else None

    def _take_due_locked(self, now: float) -> Dict[str, List[_Pending]]:
        """Pop every queue holding a request whose deadline has arrived.

        Deadlines are usually monotone per queue (submission order + equal
        budgets) but a later urgent request pulls the whole queue forward —
        it rides in the same coalesced SpMM.
        """
        due = [n for n, q in self._queues.items()
               if q and min(p.deadline for p in q) <= now]
        return {n: self._queues.pop(n) for n in due}

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                now = time.monotonic()
                nxt = self._earliest_deadline_locked()
                if nxt is None:
                    self._cv.wait()  # idle: no wakeups until a submit
                    continue
                if nxt > now:
                    self._cv.wait(timeout=nxt - now)
                    continue
                taken = self._take_due_locked(now)
            if taken:
                self.deadline_flushes += 1
                self._run_taken(taken)

    def start(self) -> None:
        """Serve deadlines from a daemon thread: each queue is flushed when
        its oldest pending request's deadline would otherwise be missed."""
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="spmv-microbatcher")
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the flush thread; ``drain`` serves the queues one last time,
        ``drain=False`` cancels them — either way no future is stranded."""
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()
        self._thread = None
        if drain:
            self.flush()
        else:
            with self._lock:
                leftovers = list(self._queues.values())
                self._queues.clear()
            for queue in leftovers:
                for p in queue:
                    p.future.cancel()

    def __enter__(self) -> "MicroBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
