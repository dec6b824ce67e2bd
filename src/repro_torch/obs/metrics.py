"""MetricsRegistry — counters, gauges and windowed percentile histograms.

Counterpart of ``repro/obs/metrics.py`` (pure Python and numpy).

The serving stack's numeric dashboard: one registry instance per service
aggregates queue depth, batch width, tokens remaining, cache hit/miss,
shed-by-reason counts and per-phase latency series.  Zero dependencies,
thread-safe, and bounded — histograms keep a sliding window of the last
``window`` observations (a ``deque(maxlen=...)``), so a week of traffic
costs the same memory as a minute.

Metrics are named with dotted paths (``serve.queue.depth``) plus optional
labels (``serve.shed{reason=queue_full}``); the (name, labels) pair is the
identity, so ``registry.counter("serve.shed", reason=r)`` returns the same
counter for the same reason every time.

This is deliberately not a Prometheus client: the consumers are the replay
report, the benchmarks and the tests, all in-process.  ``snapshot()``
renders everything as one plain JSON-safe dict.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: dict) -> _Key:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class Counter:
    """Monotonically increasing count (requests admitted, sheds, hits)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time level (queue depth, tokens remaining, inflight)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Sliding-window distribution with numpy-exact percentiles.

    Keeps the raw last ``window`` observations rather than fixed buckets:
    the series here are microsecond latencies whose interesting range moves
    with matrix size and batch width, and a few thousand floats cost less
    than getting static bucket edges wrong.  Percentiles are computed on
    demand with ``np.percentile`` (linear interpolation) over a snapshot,
    so readers never block writers beyond the snapshot copy.
    """

    __slots__ = ("name", "labels", "window", "_values", "_count", "_sum",
                 "_lock")

    def __init__(self, name: str, labels: dict, window: int = 4096):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name = name
        self.labels = dict(labels)
        self.window = window
        self._values: deque = deque(maxlen=window)
        self._count = 0  # lifetime observations (window-independent)
        self._sum = 0.0  # lifetime sum
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._values.append(float(v))
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """The q-th percentile (0..100) over the current window; 0.0 empty."""
        with self._lock:
            snap = list(self._values)
        if not snap:
            return 0.0
        return float(np.percentile(np.asarray(snap, dtype=np.float64), q))

    def summary(self) -> dict:
        """{count, mean, p50, p95, p99, max} over the window (+ lifetime
        count/sum), the shape the SLO report and benchmarks embed."""
        with self._lock:
            snap = list(self._values)
            count, total = self._count, self._sum
        if not snap:
            return {"count": count, "sum": total, "mean": 0.0, "p50": 0.0,
                    "p95": 0.0, "p99": 0.0, "max": 0.0}
        arr = np.asarray(snap, dtype=np.float64)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {
            "count": count,
            "sum": total,
            "mean": float(arr.mean()),
            "p50": float(p50),
            "p95": float(p95),
            "p99": float(p99),
            "max": float(arr.max()),
        }


class MetricsRegistry:
    """Get-or-create registry of named, labeled metrics (thread-safe).

    One instance per service; layers share it by reference.  Asking for an
    existing (name, labels) identity returns the same object; asking for it
    as a different *type* raises — a name means one thing.
    """

    def __init__(self, histogram_window: int = 4096) -> None:
        self.histogram_window = histogram_window
        self._metrics: Dict[_Key, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = _key(name, labels)
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls(name, labels, **kwargs)
                self._metrics[key] = metric
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r}{labels or ''} already registered as "
                    f"{type(metric).__name__}, requested {cls.__name__}"
                )
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: Optional[int] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         window=window or self.histogram_window)

    def snapshot(self) -> dict:
        """Everything, JSON-safe: {rendered_name: value-or-summary}.

        Counters/gauges render to floats, histograms to their
        :meth:`Histogram.summary` dict.  Labeled metrics render as
        ``name{k=v,...}`` — stable (sorted) for test assertions.
        """
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for (name, labels), metric in sorted(items):
            shown = name if not labels else (
                name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            )
            if isinstance(metric, Histogram):
                out[shown] = metric.summary()
            else:
                out[shown] = metric.value
        return out
