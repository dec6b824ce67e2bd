"""repro_torch.tune — empirical auto-tuning for SpMV execution plans.

Counterpart of ``repro.tune``, with the same names in ``__all__``.

The paper's Obs. 15 ("no one-size-fits-all scheme") made the planner
adaptive; this package makes it *empirical*.  Where ``core/adaptive.py``
predicts the winner from matrix statistics and a roofline model, the tuner
measures a shortlist of candidates on the actual machine and keeps the
fastest, caching winners so the measurement cost is paid once per
(matrix, topology, dtype, batch, search space):

    from repro_torch.api import SparseMatrix

    sm  = SparseMatrix.from_parts(rowind, colind, values, shape)
    pln = sm.plan(scheme="tune")     # measure candidates on the card
    print(pln.describe())            # measured vs analytic numbers

  * :mod:`candidates` — CandidateGenerator: schemes x formats x impls
    ("cuda" kernels by default), pruned by the shared
    ``repro_torch.api.fit_plan`` rules
  * :mod:`measure`    — Measurer (warmup + trimmed mean, per-phase splits)
    and the deterministic FakeMeasurer for tests/CI
  * :mod:`cache`      — TuningCache: winners persisted to disk, keyed on
    (fingerprint, topology, dtype, batch, impls, block); corrupt files
    degrade to empty
  * :mod:`tuner`      — Tuner: the generate -> measure -> select -> persist
    loop behind ``scheme="tune"`` and ``SpmvEngine(tune=True)``
"""

from .cache import TuneKey, TuningCache, make_key, record_to_plan, topology_key
from .candidates import CandidateGenerator
from .measure import FakeMeasurer, Measurement, Measurer
from .tuner import Tuner, TuningResult

__all__ = [
    "CandidateGenerator",
    "Measurer",
    "FakeMeasurer",
    "Measurement",
    "TuningCache",
    "TuneKey",
    "make_key",
    "record_to_plan",
    "topology_key",
    "Tuner",
    "TuningResult",
]
