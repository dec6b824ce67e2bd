"""SparseP core, in PyTorch: compressed formats, statistics, scheme selection.

  formats.py   CSR/COO/BCSR/BCOO as dataclasses of tensors (paper §2.1.1)
  stats.py     sparsity statistics + regular/scale-free/block classes (§4)
  adaptive.py  scheme auto-selection from matrix stats (paper Rec. #3)
"""
from .adaptive import HardwareModel, Plan, select_scheme  # noqa: F401
from .formats import BCOO, BCSR, COO, CSR  # noqa: F401
from .stats import MatrixStats, compute_stats  # noqa: F401
