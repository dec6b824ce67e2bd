"""repro_torch.api — the planner -> executor pipeline.

    from repro_torch.api import SparseMatrix

    sm  = SparseMatrix.from_parts(rowind, colind, values, shape)
    pln = sm.plan(scheme="auto")            # impl="cuda", device="cuda"
    exe = pln.compile()                     # Executor
    y   = exe(x)                            # host rows; exe.batch(X) for SpMM
    res = exe.iterate(x0, steps=20, combine="power")  # x stays on the card

    # the partitioned schemes: P parts on one card, one launch per request
    exe = sm.plan(scheme="auto", devices=["cuda"] * 16).compile()
"""
from .executor import (  # noqa: F401
    AXES_2D,
    AXIS_1D,
    Executor,
    MeshExecutor,
    SingleDeviceExecutor,
)
from .iterate import COMBINES, IterateResult, make_combine  # noqa: F401
from .matrix import SparseMatrix, fingerprint_matrix  # noqa: F401
from .plan import (  # noqa: F401
    FORMATS,
    IMPLS,
    IR_VERSION,
    ExecutionPlan,
    fit_plan,
    plan_from_ir,
    plan_from_partitioned,
    resolve_scheme,
)

__all__ = [
    "SparseMatrix",
    "ExecutionPlan",
    "Executor",
    "SingleDeviceExecutor",
    "MeshExecutor",
    "fit_plan",
    "resolve_scheme",
    "plan_from_ir",
    "plan_from_partitioned",
    "IR_VERSION",
    "FORMATS",
    "IMPLS",
    "AXIS_1D",
    "AXES_2D",
    "fingerprint_matrix",
    "IterateResult",
    "make_combine",
    "COMBINES",
]
