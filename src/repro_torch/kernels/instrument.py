"""Launch counters for the CUDA kernel wrappers.

Counterpart of ``repro/kernels/instrument.py``.  There the Pallas wrappers
count kernel *builds* (one per trace); here each wrapper adds one to its
count where it launches its CUDA kernel, and nowhere else — a CPU tensor
that runs the plain version counts nothing.  So a run can show that a path
really went through the kernels.  Keys are the kernel kind ("coo",
"bcoo", "ell"); launches with more than one right-hand side are also counted under
``f"{kind}.spmm"``.
"""
from __future__ import annotations

import threading
from collections import Counter

__all__ = ["LAUNCHES", "record_launch", "launches", "snapshot", "reset"]

# kind -> number of CUDA kernel launches
LAUNCHES: Counter = Counter()
# the serving path launches from the batcher's flush thread and the
# service's workers at once; an unlocked += could lose a count
_LOCK = threading.Lock()


def record_launch(kind: str, batch: int = 1) -> None:
    """Record one launch of ``kind`` for ``batch`` right-hand sides
    (thread-safe)."""
    with _LOCK:
        LAUNCHES[kind] += 1
        if batch > 1:
            LAUNCHES[f"{kind}.spmm"] += 1


def launches(kind: str | None = None) -> int:
    """Launches recorded (of one ``kind``, or the sum over every key)."""
    with _LOCK:
        if kind is not None:
            return LAUNCHES[kind]
        return sum(LAUNCHES.values())


def snapshot() -> dict:
    """Every counter, as a plain dict (thread-safe)."""
    with _LOCK:
        return dict(LAUNCHES)


def reset() -> None:
    """Zero all counters."""
    with _LOCK:
        LAUNCHES.clear()
