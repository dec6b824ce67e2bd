"""SparseP as a first-class LM feature: block-sparse layers on the block
kernel.  Counterpart of ``repro/sparse``."""
from .layers import (  # noqa: F401
    DERIVED,
    BlockSpMM,
    block_sparse_ffn_apply,
    block_sparse_ffn_init,
    sparse_linear_apply,
    sparse_linear_init,
    strip_derived,
    with_derived,
    with_row_pointer,
    with_transpose,
)
