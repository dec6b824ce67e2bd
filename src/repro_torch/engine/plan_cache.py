"""LRU cache of compiled SpMV plans.

Counterpart of ``repro/engine/plan_cache.py``.  A *compiled plan* is
everything the one-shot path rebuilds per call and the engine refuses to:
the PartitionedMatrix (host preprocessing), the device-placed arrays (the
paper's load-matrix transfer, plus the CUDA kernels' chunk plans or
block-row pointers when the plan runs ``impl="cuda"``) and the built
partitioned program.  Entries are keyed on

    (matrix fingerprint, mesh shape, dtype, scheme, impl)

so the same matrix served on a different mesh, in a different precision,
under a forced scheme, or on the other kernel impl compiles its own entry,
while a re-registered identical matrix reuses the existing one (hit).
Eviction is LRU at a fixed capacity —
placed matrices pin device memory, so the cache bound is the engine's memory
bound; evicted entries drop their device-placed tensors at once
(``CompiledPlan.release``), so the card memory the bound promises returns to
PyTorch's allocator at eviction time (``torch.cuda.memory_allocated`` falls
by the placed bytes).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from ..core.adaptive import Plan
from ..core.partition import PartitionedMatrix

__all__ = ["PlanKey", "CompiledPlan", "CacheStats", "PlanCache"]

# (fingerprint, mesh_shape, dtype, scheme, impl) — identity of one executable
PlanKey = Tuple[str, tuple, str, str, str]


@dataclass
class CompiledPlan:
    """A ready-to-run SpMV program for one (matrix, mesh, dtype, scheme, impl)."""

    key: PlanKey
    plan: Plan
    part: PartitionedMatrix  # static metadata (grid, h_pad, scheme, ...)
    arrays: dict  # device-placed matrix tensors (the cached 'load' step)
    run: Callable  # (arrays, x_device) -> SpmvOutput: the built program
    mesh: object
    axes: tuple  # mesh axis names the program uses
    x_spec: object  # the mesh axis x is split over
    x_pad: int  # x is zero-padded to this length before placement
    trace_count_fn: Callable[[], int]  # programs built (never per request)
    build_seconds: float = 0.0  # partition + place + program build wall time
    assemble_meta: Optional[dict] = None  # host row_start/row_extent/rows
    requests_served: int = 0  # multiply() calls answered by this executable
    executor: Optional[object] = None  # api MeshExecutor backing `run`
    impl: str = "cuda"  # per-part kernel: "torch" oracles or "cuda" kernels

    @property
    def trace_count(self) -> int:
        return self.trace_count_fn()

    def release(self) -> None:
        """Drop every reference to the device-placed matrix tensors
        (idempotent), so their memory returns to the allocator now.

        Called by the cache on eviction: placed tensors pin device memory and
        plans can stay reachable from host references (registry entries,
        telemetry closures), so leaving the tensors on a live plan would
        defer the free indefinitely.  A request racing an eviction on
        another thread fails with the executor's "released" error — the
        same "plan was evicted, re-register" contract the cache-miss path
        already enforces.
        """
        self.arrays = None
        if self.executor is not None:
            self.executor.release()  # holds the same placed tensors


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PlanCache:
    """LRU mapping PlanKey -> CompiledPlan with hit/miss/eviction counters."""

    def __init__(self, capacity: int = 8) -> None:
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[PlanKey, CompiledPlan]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # called with each CompiledPlan right before its device arrays are
        # released on eviction (LRU overflow, explicit evict, clear) — the
        # engine uses it to spill the host-side partition to the registry so
        # reactivation skips re-partitioning.  Must not raise.
        self.on_evict: Optional[Callable[[CompiledPlan], None]] = None

    def _release(self, entry: CompiledPlan) -> None:
        if self.on_evict is not None:
            self.on_evict(entry)
        entry.release()

    def get(self, key: PlanKey) -> Optional[CompiledPlan]:
        entry = self._entries.get(key)
        if entry is None:
            self._misses += 1
            return None
        self._entries.move_to_end(key)
        self._hits += 1
        return entry

    def peek(self, key: PlanKey) -> Optional[CompiledPlan]:
        """Lookup without touching LRU order or counters (introspection)."""
        return self._entries.get(key)

    def put(self, entry: CompiledPlan) -> Optional[CompiledPlan]:
        """Insert; returns the (released) evicted entry on capacity overflow."""
        self._entries[entry.key] = entry
        self._entries.move_to_end(entry.key)
        if len(self._entries) > self.capacity:
            _, evicted = self._entries.popitem(last=False)
            self._evictions += 1
            self._release(evicted)
            return evicted
        return None

    def evict(self, key: PlanKey) -> Optional[CompiledPlan]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._evictions += 1
            self._release(entry)
        return entry

    def clear(self) -> None:
        for entry in self._entries.values():
            self._release(entry)
        self._entries.clear()

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        """Keys from least- to most-recently used."""
        return list(self._entries.keys())

    @property
    def stats(self) -> CacheStats:
        return CacheStats(
            hits=self._hits,
            misses=self._misses,
            evictions=self._evictions,
            size=len(self._entries),
            capacity=self.capacity,
        )
