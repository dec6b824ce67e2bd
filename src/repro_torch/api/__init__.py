"""repro_torch.api — the single-device planner -> executor pipeline.

    from repro_torch.api import SparseMatrix

    sm  = SparseMatrix.from_parts(rowind, colind, values, shape)
    pln = sm.plan(scheme="auto")            # impl="cuda", device="cuda"
    exe = pln.compile()                     # Executor
    y   = exe(x)                            # host rows; exe.batch(X) for SpMM
"""
from .executor import Executor, SingleDeviceExecutor  # noqa: F401
from .matrix import SparseMatrix, fingerprint_matrix  # noqa: F401
from .plan import (  # noqa: F401
    FORMATS,
    IMPLS,
    IR_VERSION,
    ExecutionPlan,
    fit_plan,
    plan_from_ir,
    resolve_scheme,
)

__all__ = [
    "SparseMatrix",
    "ExecutionPlan",
    "Executor",
    "SingleDeviceExecutor",
    "fit_plan",
    "resolve_scheme",
    "plan_from_ir",
    "IR_VERSION",
    "FORMATS",
    "IMPLS",
    "fingerprint_matrix",
]
