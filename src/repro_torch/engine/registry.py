"""Named-matrix registry with structural fingerprinting.

Counterpart of ``repro/engine/registry.py``; the fingerprint is the JAX
package's hash of the same matrix (``repro_torch.api.matrix``).

A fingerprint identifies a matrix up to exact value/structure equality: two
registrations with the same fingerprint can share one partitioned, placed and
compiled plan (paper §3.1: preprocessing is per-matrix, so identity is what
makes caching sound).  The fingerprint folds in shape, dtype and the raw
nonzero payload, so a re-registered identical matrix is a cache hit while any
edit — even one value — is a miss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from ..api.matrix import fingerprint_matrix  # canonical implementation
from ..core.adaptive import Plan
from ..core.stats import MatrixStats

__all__ = ["fingerprint_matrix", "RegisteredMatrix", "MatrixRegistry"]


@dataclass
class RegisteredMatrix:
    """One serving-registry entry: identity, statistics and the chosen plan."""

    name: str
    fingerprint: str
    shape: tuple
    dtype: str
    stats: MatrixStats
    plan: Plan
    cache_key: tuple  # PlanKey of the compiled executable in the plan cache
    requests: int = 0  # multiplies served (batch of B counts as B)
    matrix: Optional[object] = None  # api.SparseMatrix (host-side), kept so
    # the background tuner can re-plan candidates without the caller
    # re-providing the dense array
    tuned: bool = False  # a measure-and-refine pass completed for this entry
    last_x: Optional[object] = None  # most recent input (representative
    # traffic the tuner measures candidates on): a copy, never the caller's
    last_x_ready: Optional[object] = None  # torch.cuda.Event recorded after
    # a card copy of last_x, on the stream that made it; None off the card
    spill: Optional[object] = None  # host-side PartitionedMatrix kept at
    # plan-cache eviction, so reactivation re-places without re-partitioning
    # (let alone rebuilding from dense)
    tuned_batch: Optional[float] = None  # batch width the last refinement
    # measured at (the drift re-tune reference point)
    batch_ewma: Optional[float] = None  # EWMA of served batch widths; when
    # it drifts drift_factor x away from tuned_batch, the engine re-tunes

    def summary(self) -> dict:
        """JSON-safe identity + serving state — what crosses a process
        boundary (the cluster worker's ``stats`` verb) without dragging
        the host-side matrix or live plan objects along."""
        return {
            "name": self.name,
            "fingerprint": self.fingerprint,
            "shape": tuple(self.shape),
            "dtype": self.dtype,
            "scheme_id": self.plan.tag,
            "impl": self.cache_key[4],
            "requests": self.requests,
            "tuned": self.tuned,
        }


class MatrixRegistry:
    """name -> RegisteredMatrix.  Thin, but the one place names resolve."""

    def __init__(self) -> None:
        self._entries: Dict[str, RegisteredMatrix] = {}

    def add(self, entry: RegisteredMatrix) -> RegisteredMatrix:
        self._entries[entry.name] = entry
        return entry

    def get(self, name: str) -> RegisteredMatrix:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"matrix {name!r} is not registered "
                f"(registered: {sorted(self._entries)})"
            ) from None

    def find(self, name: str) -> Optional[RegisteredMatrix]:
        return self._entries.get(name)

    def remove(self, name: str) -> Optional[RegisteredMatrix]:
        return self._entries.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[RegisteredMatrix]:
        return iter(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)
