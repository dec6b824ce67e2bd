"""Elastic rescaling: continue a run on a different device count.

Counterpart of ``repro/runtime/elastic.py``'s mesh arithmetic.  Checkpoints
store full (unsharded) leaves, so a restore may target another mesh shape;
picking that shape is :func:`rescale_mesh_shape`.  ``make_shardings`` and
``sanitize_shardings`` wait for multi-card meshes (ROADMAP.md §1 item 7).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["rescale_mesh_shape", "RescalePlan"]


@dataclass(frozen=True)
class RescalePlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    reason: str = ""


def rescale_mesh_shape(n_devices: int, axis_names=("data", "model"),
                       model_parallel: int | None = None) -> tuple:
    """Largest usable mesh for n_devices: keep model parallelism fixed (it is
    dictated by per-chip memory), shrink the data axis; drop remainder
    devices (they become hot spares)."""
    if model_parallel is None:
        model_parallel = 1
    data = max(1, n_devices // model_parallel)
    if len(axis_names) == 3:  # (pod, data, model): collapse pods on rescale
        return (1, data, model_parallel)
    return (data, model_parallel)
