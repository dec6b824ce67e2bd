"""Data substrate: synthetic matrices (paper Tables 3/4) and the LM token
stream.  Counterpart of ``repro/data``."""
from .matrices import (  # noqa: F401
    MatrixSpec,
    block_matrix,
    paper_large_suite,
    paper_small_suite,
    regular_matrix,
    scale_free_matrix,
)
from .tokens import TokenStream, make_batch  # noqa: F401
