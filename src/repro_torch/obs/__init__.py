"""repro_torch.obs — end-to-end observability for the serving stack.

Counterpart of ``repro/obs``, with the same exports.

SparseP's method is phase decomposition (load / kernel / retrieve, Figs. 4
and 17-24): you only understand a partitioning scheme by seeing where its
time goes.  This package applies the same discipline to the whole serving
path, so a single trace shows where a request's deadline went:

  * :mod:`tracing` — ``Span`` / ``Tracer``: zero-dep, monotonic-clock,
    thread-safe, ring-buffered request-lifecycle tracing
    (``admit -> queue_wait -> batch_form -> load -> kernel -> retrieve ->
    deliver``), with Chrome/Perfetto trace export (``chrome_trace``) and
    per-request rollups (``trace_summary``).
  * :mod:`metrics` — ``MetricsRegistry``: counters, gauges and windowed
    p50/p95/p99 histograms for queue depth, batch width, tokens remaining,
    cache hit/miss, shed-by-reason and per-phase latency series.
  * :mod:`profile` — guarded ``torch.profiler`` / NVTX annotation
    wrappers (``annotate`` / ``step_annotate``) that label plan compiles
    and kernel launches inside an externally captured device profile, and
    degrade to no-ops when disabled.

Wiring: `repro_torch.serve.AsyncSpmvService` owns a ``Tracer`` +
``MetricsRegistry`` and threads a per-request trace through
`repro_torch.engine.MicroBatcher` into `repro_torch.engine.SpmvEngine.multiply`;
`repro_torch.serve.replay` folds the spans into the SLO report's per-phase
attribution.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .profile import annotate, profiler_available, set_enabled, step_annotate
from .tracing import (
    NULL_TRACE,
    PHASES,
    NullTrace,
    Span,
    Trace,
    Tracer,
    chrome_trace,
    merge_chrome_traces,
    trace_summary,
)

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
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "annotate",
    "step_annotate",
    "set_enabled",
    "profiler_available",
]
