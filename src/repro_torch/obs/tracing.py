"""Span tracing — the request-lifecycle instrument behind the SLO numbers.

Counterpart of ``repro/obs/tracing.py`` (pure Python, the same spans).

SparseP's whole analysis method is phase decomposition: every figure splits
SpMV into load / kernel / retrieve+merge to show *where* the time goes as
partitioning and balancing change (Figs. 4, 17-24).  The serving stack has
more phases than the kernel does — a request can die in the admission
check, the coalescing queue or the batcher long before the kernel runs —
so this module generalizes the three-phase telemetry into a request
lifecycle trace:

    admit -> queue_wait -> batch_form -> load -> kernel -> retrieve -> deliver

Design constraints (this sits on the hot serving path):

  * **zero-dep, monotonic**: timestamps are ``time.perf_counter()`` — one
    clock for every layer, so spans recorded on the event loop, the flush
    thread and a worker thread line up on a shared timeline.
  * **ring-buffered**: the tracer holds the last ``capacity`` spans in a
    ``deque(maxlen=...)``; a week-long replay cannot grow it.
  * **thread-safe**: span appends are single ``deque.append`` calls (atomic
    under the GIL); id allocation holds a lock.
  * **free when off**: a disabled tracer hands out one shared
    :data:`NULL_TRACE` whose every method is a no-op returning shared
    singletons — the tracer-off hot path allocates nothing per request.

Spans are recorded *completed* (begin+end in one call) because every phase
boundary is already a measured timestamp in the serving code; there is no
open-span bookkeeping to leak.  :func:`chrome_trace` renders a tracer's
buffer as a Chrome ``chrome://tracing`` / Perfetto-loadable JSON object in
which each request is one timeline row.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

__all__ = [
    "PHASES",
    "Span",
    "Trace",
    "NullTrace",
    "NULL_TRACE",
    "Tracer",
    "chrome_trace",
    "merge_chrome_traces",
    "trace_summary",
]

# Canonical request-lifecycle phase names, in timeline order.  Layers are
# free to add others (e.g. "plan_compile"), but these are the ones the SLO
# attribution and the 5%-coverage contract are defined over.
PHASES = (
    "admit",
    "queue_wait",
    "batch_form",
    "load",
    "kernel",
    "retrieve",
    "deliver",
)

clock = time.perf_counter  # the one monotonic clock every layer stamps with


@dataclass(frozen=True)
class Span:
    """One completed, named interval of a request's lifecycle."""

    trace_id: int  # groups spans into one request's trace
    name: str  # phase name ("kernel", "queue_wait", ...)
    start_s: float  # clock() at span begin
    end_s: float  # clock() at span end
    label: str = ""  # the owning trace's label (tenant/matrix)
    args: dict = field(default_factory=dict)  # small JSON-safe annotations

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


class Trace:
    """Per-request handle: appends completed spans into the owning tracer.

    Cheap by construction — three attributes and no per-span allocation
    beyond the :class:`Span` itself.  ``last_end`` tracks the latest span
    end so a follow-up phase (``deliver``) can tile the timeline gaplessly
    without the recording layer knowing which phase ran last.
    """

    __slots__ = ("tracer", "trace_id", "label", "first_start", "last_end")

    def __init__(self, tracer: "Tracer", trace_id: int, label: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.label = label
        self.first_start: Optional[float] = None
        self.last_end: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return True

    def add(self, name: str, start_s: float, end_s: float, **args) -> None:
        """Record one completed span (thread-safe; any thread may call)."""
        if self.first_start is None or start_s < self.first_start:
            self.first_start = start_s
        if self.last_end is None or end_s > self.last_end:
            self.last_end = end_s
        self.tracer._append(Span(
            trace_id=self.trace_id, name=name, start_s=start_s, end_s=end_s,
            label=self.label, args=args,
        ))

    @contextmanager
    def span(self, name: str, **args):
        """Context manager sugar for a timed block."""
        t0 = clock()
        try:
            yield self
        finally:
            self.add(name, t0, clock(), **args)


class NullTrace:
    """The disabled-tracing stand-in: every method is a no-op.

    One shared instance (:data:`NULL_TRACE`) is handed to every request, so
    the tracer-off hot path performs zero allocations — the overhead guard
    in tests/test_obs.py pins this down.
    """

    __slots__ = ()
    trace_id = -1
    label = ""
    first_start = None
    last_end = None

    @property
    def enabled(self) -> bool:
        return False

    def add(self, name, start_s, end_s, **args) -> None:
        pass

    def span(self, name, **args):
        return _NULL_CONTEXT


class _NullContext:
    """Reusable no-op context manager (shared; never allocated per call)."""

    __slots__ = ()

    def __enter__(self):
        return NULL_TRACE

    def __exit__(self, *exc) -> bool:
        return False


NULL_TRACE = NullTrace()
_NULL_CONTEXT = _NullContext()


class Tracer:
    """Ring-buffered span sink; hands out per-request :class:`Trace` handles.

    Args:
      capacity: max spans retained (oldest evicted first).  A request emits
        ~7 spans, so the default keeps roughly the last 2k requests.
      enabled: when False, :meth:`trace` returns the shared
        :data:`NULL_TRACE` and nothing is ever recorded or allocated.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._next_id = 0
        self.dropped = 0  # spans evicted by the ring (observability honesty)

    def trace(self, label: str = ""):
        """A new request trace — or the shared no-op when disabled."""
        if not self.enabled:
            return NULL_TRACE
        with self._lock:
            trace_id = self._next_id
            self._next_id += 1
        return Trace(self, trace_id, label)

    def _append(self, span: Span) -> None:
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(span)

    def spans(self, trace_id: Optional[int] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot of the buffer, optionally filtered by trace or phase."""
        snap = list(self._spans)
        if trace_id is not None:
            snap = [s for s in snap if s.trace_id == trace_id]
        if name is not None:
            snap = [s for s in snap if s.name == name]
        return snap

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._spans)

    def chrome_trace(self) -> dict:
        """The buffer as a Chrome/Perfetto trace document (see module doc)."""
        return chrome_trace(self.spans())


def chrome_trace(spans: Iterable[Span]) -> dict:
    """Render spans as a ``chrome://tracing`` / Perfetto JSON object.

    Each trace (request) becomes one thread row (``tid`` = trace id) named
    by its label, with complete-duration events (``ph: "X"``) per span.
    Timestamps are microseconds relative to the earliest span, so the
    viewer opens at t=0 instead of hours into the process uptime.
    """
    spans = list(spans)
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s.start_s for s in spans)
    events = []
    seen_tids: Dict[int, str] = {}
    for s in spans:
        if s.trace_id not in seen_tids:
            seen_tids[s.trace_id] = s.label or f"trace-{s.trace_id}"
        events.append({
            "name": s.name,
            "cat": "serve",
            "ph": "X",
            "pid": 1,
            "tid": s.trace_id,
            "ts": (s.start_s - t0) * 1e6,
            "dur": s.duration_s * 1e6,
            "args": dict(s.args),
        })
    events.append({
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": "repro_torch.serve replay"},
    })
    for tid, label in seen_tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": label},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_chrome_traces(docs: Iterable[dict],
                        labels: Optional[List[str]] = None) -> dict:
    """Merge per-process Chrome trace documents into one cluster timeline.

    Each input document (one :func:`chrome_trace` output per worker)
    becomes one Perfetto *process* row: its events are re-stamped with
    ``pid`` = 1-based document index and its ``process_name`` metadata is
    replaced by the worker's label, so a ``--workers N`` replay renders as
    N labeled process groups in a single viewer tab.

    Timestamps stay relative to each document's own t0: workers run their
    own monotonic clocks, so cross-process offsets are not meaningful and
    re-basing would fabricate an alignment that was never measured.

    Args:
      docs: Chrome trace dicts (``{"traceEvents": [...]}``); empty or
        event-less documents still claim a pid so labels stay aligned.
      labels: per-document process names (default ``worker-<i>``).

    Returns:
      One merged Chrome/Perfetto trace document.
    """
    labels = list(labels) if labels is not None else []
    events: List[dict] = []
    for i, doc in enumerate(docs):
        pid = i + 1
        label = labels[i] if i < len(labels) else f"worker-{i}"
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the per-worker name below
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": label},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_summary(spans: Iterable[Span]) -> Dict[int, dict]:
    """Per-trace rollup: phase durations, end-to-end span, coverage.

    Returns {trace_id: {label, start_s, end_s, total_s, phases: {name:
    seconds}, coverage}} where ``coverage`` is (sum of span durations) /
    (end-to-end extent) — the quantity the acceptance contract bounds at
    >= 0.95 for accepted requests.  Traces made of one span have coverage
    1.0 by construction.
    """
    out: Dict[int, dict] = {}
    for s in spans:
        t = out.setdefault(s.trace_id, {
            "label": s.label, "start_s": s.start_s, "end_s": s.end_s,
            "phases": {},
        })
        t["start_s"] = min(t["start_s"], s.start_s)
        t["end_s"] = max(t["end_s"], s.end_s)
        t["phases"][s.name] = t["phases"].get(s.name, 0.0) + s.duration_s
    for t in out.values():
        t["total_s"] = t["end_s"] - t["start_s"]
        spanned = sum(t["phases"].values())
        t["coverage"] = spanned / t["total_s"] if t["total_s"] > 0 else 1.0
    return out
