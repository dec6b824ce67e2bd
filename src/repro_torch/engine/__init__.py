"""repro_torch.engine — a batched SpMV serving engine with plan caching.

Counterpart of ``repro/engine``, with the same exports.

The paper's preprocessing costs (format conversion, partitioning, transfer to
the PIM banks) only pay off when amortized over many multiplications of the
same matrix.  This package is that amortization layer, built on the
``repro_torch.api`` pipeline (``SparseMatrix -> ExecutionPlan -> Executor``):

  * :mod:`registry`   — named matrices, fingerprinted via repro_torch.api
  * :mod:`plan_cache` — LRU cache of compiled api Executors keyed on
                        (fingerprint, mesh, dtype, scheme, impl); eviction
                        frees the device-placed tensors
  * :mod:`engine`     — SpmvEngine: register once, multiply many times with
                        zero re-partitioning / program rebuilds
  * :mod:`batcher`    — deadline-aware micro-batching of concurrent multiply
                        requests into SpMM (multi-RHS) calls
  * :mod:`telemetry`  — per-request load / kernel / retrieve time splits
                        (paper Fig. 17 breakdown)
"""
from .batcher import MicroBatcher
from .engine import SpmvEngine
from .plan_cache import CacheStats, CompiledPlan, PlanCache, PlanKey
from .registry import MatrixRegistry, RegisteredMatrix, fingerprint_matrix
from .telemetry import RequestRecord, Telemetry

__all__ = [
    "SpmvEngine",
    "MicroBatcher",
    "PlanCache",
    "PlanKey",
    "CompiledPlan",
    "CacheStats",
    "MatrixRegistry",
    "RegisteredMatrix",
    "fingerprint_matrix",
    "Telemetry",
    "RequestRecord",
]
