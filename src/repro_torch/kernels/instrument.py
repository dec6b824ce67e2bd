"""Launch counters for the CUDA kernel wrappers, and the kernels' work.

Counterpart of ``repro/kernels/instrument.py``.  There the Pallas wrappers
count kernel *builds* (one per trace); here each wrapper adds one to its
count where it launches its CUDA kernel, and nowhere else — a CPU tensor
that runs the plain version counts nothing.  So a run can show that a path
really went through the kernels.  Keys are the kernel kind ("coo",
"bcoo", "ell"); launches with more than one right-hand side are also counted under
``f"{kind}.spmm"``.

The kernels' work, for :mod:`repro_torch.analysis.count`: a count of a
step cannot see into a ctypes launch, so each wrapper reports the useful
FLOPs and the bytes of its call (each input read once, the output written
once, as a roofline counts them), whichever path computes it.  Work is
recorded only while a count listens (:func:`listening`), so a launch
outside a count costs nothing more; ``work`` is then a callable that
returns ``(flops, bytes)``, evaluated only when one does.  While a wrapper
runs (:func:`kernel_scope`, per thread), a count takes its work from the
report and not from the aten ops of its plain version.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

__all__ = ["LAUNCHES", "record_launch", "record_work", "launches", "snapshot",
           "reset", "kernel_scope", "in_kernel", "listening", "work"]

# kind -> number of CUDA kernel launches
LAUNCHES: Counter = Counter()
# kind -> useful FLOPs / bytes reported while a count listened
FLOPS: Counter = Counter()
BYTES: Counter = Counter()
# the serving path launches from the batcher's flush thread and the
# service's workers at once; an unlocked += could lose a count
_LOCK = threading.Lock()
_LISTENERS = [0]  # counts that take the kernels' work now
_SCOPE = threading.local()  # .depth: wrappers running on this thread


def record_work(kind: str, work=None) -> None:
    """Add ``work() -> (flops, bytes)`` under ``kind`` while a count listens."""
    if work is None or not _LISTENERS[0]:
        return
    flops, nbytes = work()
    with _LOCK:
        FLOPS[kind] += int(flops)
        BYTES[kind] += int(nbytes)


def record_launch(kind: str, batch: int = 1, work=None) -> None:
    """Record one launch of ``kind`` for ``batch`` right-hand sides, and
    its useful FLOPs and bytes (``work``, see :func:`record_work`)
    (thread-safe)."""
    with _LOCK:
        LAUNCHES[kind] += 1
        if batch > 1:
            LAUNCHES[f"{kind}.spmm"] += 1
    record_work(kind, work)


def launches(kind: str | None = None) -> int:
    """Launches recorded (of one ``kind``, or the sum over every key)."""
    with _LOCK:
        if kind is not None:
            return LAUNCHES[kind]
        return sum(LAUNCHES.values())


def snapshot() -> dict:
    """Every launch counter, as a plain dict (thread-safe)."""
    with _LOCK:
        return dict(LAUNCHES)


def work() -> tuple:
    """``(flops, bytes)`` recorded so far, summed over the kinds."""
    with _LOCK:
        return sum(FLOPS.values()), sum(BYTES.values())


def reset() -> None:
    """Zero all counters."""
    with _LOCK:
        LAUNCHES.clear()
        FLOPS.clear()
        BYTES.clear()


@contextlib.contextmanager
def listening():
    """Record the kernels' work while this is open (counts nest)."""
    with _LOCK:
        _LISTENERS[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _LISTENERS[0] -= 1


@contextlib.contextmanager
def kernel_scope():
    """Mark a kernel wrapper's call on this thread (see the module doc)."""
    _SCOPE.depth = getattr(_SCOPE, "depth", 0) + 1
    try:
        yield
    finally:
        _SCOPE.depth -= 1


def in_kernel() -> bool:
    """Whether a kernel wrapper runs on this thread."""
    return getattr(_SCOPE, "depth", 0) > 0
