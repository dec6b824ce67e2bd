"""Guarded profiler annotation wrappers.

Counterpart of ``repro/obs/profile.py``.  Each label is a
``torch.profiler.record_function`` range — a ``torch.profiler`` trace then
shows *which request / which phase* issued each kernel launch, the join
between the serving timeline and the device timeline — and, when a CUDA
device is present, an NVTX range (``torch.cuda.nvtx.range_push/pop``) for
profilers outside the process.  The serving stack must run identically
where no profiler exists, so every wrapper here degrades to a shared no-op
context manager when

  * ``torch.profiler.record_function`` is unavailable, or
  * annotations are disabled (``set_enabled(False)`` or the
    ``REPRO_OBS_PROFILE=0`` environment variable).

The wrappers are *labels*, not measurements: span timing is the tracing
layer's job (:mod:`repro_torch.obs.tracing`); these only make the phases
visible inside an externally captured profile.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch

__all__ = ["annotate", "step_annotate", "set_enabled", "profiler_available"]

try:  # a stripped torch build must not break serving
    from torch.profiler import record_function as _record_function

    _AVAILABLE = True
except Exception:  # pragma: no cover - exercised only on stripped installs
    _record_function = None
    _AVAILABLE = False

_enabled = _AVAILABLE and os.environ.get("REPRO_OBS_PROFILE", "1") != "0"


class _NullAnnotation:
    """Shared no-op annotation (never allocated per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullAnnotation()


@functools.cache
def _nvtx() -> bool:
    """NVTX ranges are emitted only where a CUDA device is present."""
    return torch.cuda.is_available()


class _Annotation:
    """A ``record_function`` range, plus an NVTX range on a CUDA machine."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name = name
        self._rf = _record_function(name, args)

    def __enter__(self):
        self._rf.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def profiler_available() -> bool:
    """True when profiler annotations can be emitted at all."""
    return _AVAILABLE


def set_enabled(on: bool) -> bool:
    """Toggle annotation emission; returns the effective state (stays off
    when the profiler is unavailable)."""
    global _enabled
    _enabled = bool(on) and _AVAILABLE
    return _enabled


def annotate(name: str, **kwargs):
    """A labelled profiler range — or the shared no-op when disabled.

    Use around host-side regions worth seeing in a device profile: plan
    compile, kernel launch, batch formation.  ``kwargs`` ride along as the
    range's argument string.
    """
    if not _enabled:
        return _NULL
    return _Annotation(name, repr(kwargs) if kwargs else None)


def step_annotate(name: str, step: Optional[int] = None):
    """A profiler 'step' marker — or the no-op.

    torch has no step annotation of its own, so a step is a range named
    ``name#step`` (the JAX package stamps one per coalesced batch with the
    batch ordinal).
    """
    if not _enabled:
        return _NULL
    return _Annotation(name if step is None else f"{name}#{step}")
