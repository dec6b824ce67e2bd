"""Data substrate: synthetic matrices (paper Tables 3/4).

Counterpart of ``repro/data``; the LM token streams (``tokens.py``) wait
for the LM side of the port (ROADMAP.md).
"""
from .matrices import (  # noqa: F401
    MatrixSpec,
    block_matrix,
    paper_large_suite,
    paper_small_suite,
    regular_matrix,
    scale_free_matrix,
)
