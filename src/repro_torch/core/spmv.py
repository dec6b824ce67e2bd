"""Single-device SpMV dispatch (facade — use ``repro_torch.api``).

Counterpart of ``repro/core/spmv.py``: ``repro_torch.core.spmv.spmv``
resolves to the kernel dispatch in ``kernels/ops.py`` with identical
semantics.  New code goes through the planner -> executor pipeline:

    from repro_torch.api import SparseMatrix
    exe = SparseMatrix.from_dense(a).plan(fmt="coo").compile()
    y = exe(x)
"""
from ..kernels.ops import spmv  # noqa: F401

__all__ = ["spmv"]
