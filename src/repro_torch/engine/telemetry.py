"""Per-request timing telemetry — the paper's Fig. 17 execution breakdown.

The paper decomposes every SpMV into load (transfer x to the banks), kernel
(the PIM computation) and retrieve+merge (gather partials, merge on host).
The engine's serving path has the same three phases on the card
(counterpart of ``repro/engine/telemetry.py``):

    load     — place x on the mesh's device (host -> HBM copy)
    kernel   — the part-axis kernel launch and the merge on the part axis
    retrieve — device -> host copy and row assembly of the output

Each request runs on its host thread's own CUDA stream and each phase ends
in a wait on that stream alone, so with several host threads serving at
once a phase time holds its own request's work only.  A solver session
(``SpmvEngine.solve``) is one record of ``kind="solve"``: load is x0 and
its parameters, kernel the whole loop of ``steps`` SpMVs, retrieve the
solution.

Each request appends one :class:`RequestRecord`; :meth:`Telemetry.breakdown`
aggregates the per-phase fractions per matrix, which is exactly the stacked
bar of Fig. 17 (and what benchmarks/engine_throughput.py prints).

On a world of ranks (``SpmvEngine(world=)``) the records are rank 0's:
load is validating x and scattering each rank its shard, kernel every
rank's tile kernel and the merge, retrieve the gather of the parts and the
copy of y to the host.  :meth:`Telemetry.record_collectives` adds, per
matrix, the seconds rank 0 spent in each kind of collective
(``exe.collectives``' kinds, ``"scatter"`` the load) and in the kernel
phase's collectives (the merge), read with :meth:`Telemetry.collectives`;
the records and :meth:`Telemetry.breakdown` stay the reference's.

The per-request log is a **ring buffer**: only the most recent
``max_records`` records are retained (long replays used to hold millions of
records alive), while the per-matrix aggregates in :meth:`breakdown` stay
exact over the full lifetime — they are folded in at :meth:`record` time,
never recomputed from the ring.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["RequestRecord", "Telemetry"]


@dataclass(frozen=True)
class RequestRecord:
    name: str  # registered matrix name
    batch: int  # number of RHS vectors served by this execution
    load_s: float
    kernel_s: float
    retrieve_s: float
    cache_hit: bool  # the plan had served before (steady state) vs first serve
    traced: bool  # this request triggered a (re)trace
    kind: str = "multiply"  # "multiply" | "solve" (one record per session)
    steps: int = 1  # SpMV steps this record covers (solve sessions > 1)

    @property
    def total_s(self) -> float:
        return self.load_s + self.kernel_s + self.retrieve_s

    @property
    def per_iter_s(self) -> float:
        """Loop seconds per SpMV step — a solve session's unit cost (for a
        multiply this is just the kernel time)."""
        return self.kernel_s / max(1, self.steps)


@dataclass
class _Agg:
    requests: int = 0
    vectors: int = 0
    load_s: float = 0.0
    kernel_s: float = 0.0
    retrieve_s: float = 0.0
    traces: int = 0
    solves: int = 0
    solve_steps: int = 0


class Telemetry:
    """Ring-buffered request log + exact per-matrix aggregation.

    Args:
      keep_records: retain individual :class:`RequestRecord`\\ s (the engine
        default).  Aggregates are kept either way.
      max_records: ring capacity when keeping records — the memory bound for
        long-running serving.  ``None`` restores the unbounded legacy
        behavior (tests only; a served engine should always be bounded).
    """

    def __init__(self, keep_records: bool = True,
                 max_records: Optional[int] = 10_000) -> None:
        if max_records is not None and max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self._keep = keep_records
        self.max_records = max_records
        self._records: deque = deque(maxlen=max_records)
        self._by_name: Dict[str, _Agg] = {}
        self._last: Dict[str, RequestRecord] = {}
        self._last_solve: Dict[str, RequestRecord] = {}
        self._coll: Dict[str, dict] = {}  # name -> collective seconds
        # the batcher's flush thread and the service's workers record at
        # once; the aggregates must count every request
        self._lock = threading.Lock()

    @property
    def records(self) -> List[RequestRecord]:
        """The retained records, oldest first (a list copy of the ring)."""
        with self._lock:
            return list(self._records)

    def last(self, name: str) -> Optional[RequestRecord]:
        """The most recent *multiply* record for ``name`` (None before the
        first request) — O(1); the serving layer's service-time estimator
        reads it on every request.  Solve sessions are deliberately
        excluded: a 200-step session's total would otherwise masquerade as
        the per-multiply service time and shed every feasible multiply
        that follows (see :meth:`last_solve`)."""
        return self._last.get(name)

    def last_solve(self, name: str) -> Optional[RequestRecord]:
        """The most recent *solve* record for ``name`` (None before the
        first session) — the per-iteration estimator the serving layer's
        solve-deadline feasibility check reads (``rec.per_iter_s``)."""
        return self._last_solve.get(name)

    def record(self, rec: RequestRecord) -> None:
        with self._lock:
            if self._keep:
                self._records.append(rec)  # deque drops the oldest at capacity
            if rec.kind == "solve":
                self._last_solve[rec.name] = rec
            else:
                self._last[rec.name] = rec
            agg = self._by_name.setdefault(rec.name, _Agg())
            agg.requests += 1
            agg.vectors += rec.batch
            agg.load_s += rec.load_s
            agg.kernel_s += rec.kernel_s
            agg.retrieve_s += rec.retrieve_s
            agg.traces += int(rec.traced)
            if rec.kind == "solve":
                agg.solves += 1
                agg.solve_steps += rec.steps

    def record_collectives(self, name: str, seconds: Dict[str, float],
                           merge_s: float) -> None:
        """Add one request's collective seconds on rank 0 of a world, by
        kind, and its kernel phase's (the merge) to ``name``'s sums."""
        with self._lock:
            agg = self._coll.setdefault(name, {"requests": 0, "merge_s": 0.0,
                                               "seconds": {}})
            agg["requests"] += 1
            agg["merge_s"] += merge_s
            for kind, v in seconds.items():
                agg["seconds"][kind] = agg["seconds"].get(kind, 0.0) + v

    def collectives(self, name: Optional[str] = None) -> dict:
        """{matrix: {requests, merge_s, seconds: {kind: s}}} summed over the
        requests served on a world (or the one dict when ``name`` given;
        empty off a world)."""
        with self._lock:
            out = {n: {"requests": a["requests"], "merge_s": a["merge_s"],
                       "seconds": dict(a["seconds"])}
                   for n, a in self._coll.items()}
        return out.get(name, {}) if name is not None else out

    def breakdown(self, name: Optional[str] = None) -> dict:
        """Fig.-17-style per-phase split (exact, full-lifetime aggregates).

        Returns {matrix: {load, kernel, retrieve (fractions), total_s,
        requests, vectors, traces}} — or the single dict when ``name`` given.
        A matrix whose every request measured ``total == 0`` (mocked or
        fake-measurer paths) reports ``None`` fractions rather than an
        all-zero split that sums to 0 instead of 1 — consumers asserting
        fraction sums (or printing stacked bars) must skip those entries.
        """
        out = {}
        with self._lock:
            aggs = [(n, dataclasses.replace(agg))
                    for n, agg in self._by_name.items()]
        for n, agg in aggs:
            total = agg.load_s + agg.kernel_s + agg.retrieve_s
            out[n] = {
                "requests": agg.requests,
                "vectors": agg.vectors,
                "traces": agg.traces,
                "solves": agg.solves,
                "solve_steps": agg.solve_steps,
                "total_s": total,
                "load": agg.load_s / total if total else None,
                "kernel": agg.kernel_s / total if total else None,
                "retrieve": agg.retrieve_s / total if total else None,
            }
        if name is not None:
            return out.get(name, {})
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._by_name.clear()
            self._last.clear()
            self._last_solve.clear()
            self._coll.clear()
