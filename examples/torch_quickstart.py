"""Quickstart over the PyTorch + CUDA port: the repro_torch.api pipeline —
SparseMatrix -> ExecutionPlan -> Executor.

Every SpMV path (any container format, the plain torch oracles or the
hand-written CUDA kernels, one part or many on the card) runs through the
same three steps:

    sm  = SparseMatrix.from_dense(a)     # wrap + stats (or from_scipy /
                                         #   from_parts / from_format)
    pln = sm.plan(...)                   # inspectable ExecutionPlan
    y   = pln.compile()(x)               # Executor: y = exe(x), Y = exe.batch(X)

It runs on the card unless asked for the CPU; there the "cuda" impl is not
run (on a CPU tensor a kernel wrapper runs its plain version, which is not
the kernel):

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import SparseMatrix
from repro_torch.api.plan import check_device
from repro_torch.core.adaptive import HardwareModel
from repro_torch.data import scale_free_matrix
from repro_torch.kernels.ops import IMPLS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    impls = IMPLS if device.type == "cuda" else ("torch",)
    if device.type != "cuda":
        print("impl 'cuda' not run: the kernels need the card")

    # 1. Wrap a scale-free sparse matrix (web-graph-like, paper Table 4
    #    class).  SparseMatrix carries the paper's Table-4 statistics and
    #    classification.
    a = scale_free_matrix(rows=1024, cols=1024, nnz_target=6 * 1024, seed=0)
    sm = SparseMatrix.from_dense(a)
    st = sm.stats
    print(f"matrix: {sm} NNZ-r-std={st.nnz_r_std:.1f} -> "
          f"{'scale-free' if st.is_scale_free else 'regular'}")

    # 2. One call signature across every compressed format and impl.
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    y_ref = a @ x
    spmv, ys = {}, {}
    for fmt in ("csr", "coo", "bcsr", "bcoo"):
        for impl in impls:
            exe = sm.plan(fmt=fmt, impl=impl, block=(8, 128),
                          device=device).compile()
            ys[fmt, impl] = exe(x)
            spmv[fmt, impl] = err = float(np.abs(ys[fmt, impl] - y_ref).max())
            print(f"  {fmt.upper():5s} [{impl:6s}] max|err| = {err:.2e}")

    # 3. Batched SpMM through the same executor (amortizes the matrix
    #    traffic).  With impl="cuda" the batch runs the multi-RHS kernel —
    #    the matrix stream is paid once per batch, not once per column.
    X = np.random.default_rng(1).standard_normal((1024, 4)).astype(np.float32)
    batch = {}
    for impl in impls:
        exe = sm.plan(fmt="coo", impl=impl, device=device).compile()
        batch[impl] = err = float(np.abs(exe.batch(X) - a @ X).max())
        print(f"  batch(X) [{impl:6s}] max|err| = {err:.2e}")

    # 4. The adaptive planner (paper Rec. #3): scheme="auto" picks the
    #    (partitioning, balancing, format) tuple for the matrix + hardware
    #    and returns it as a first-class, inspectable plan.  fit=False shows
    #    the 256-card pod's plan as-is (fitting would collapse the grid to
    #    one part); passing devices=[device] * P to sm.plan() runs the
    #    fitted plan over P parts (see examples/torch_spmv_end_to_end.py).
    plan = sm.plan(scheme="auto", hw=HardwareModel.single_pod(), fit=False,
                   device=device)
    print(plan.describe())
    s = plan.scheme
    return {"impls": list(impls), "spmv_err": spmv, "batch_err": batch,
            "y": ys, "plan": (s.partitioning, s.scheme, s.fmt, s.merge, tuple(s.grid)),
            "describe": plan.describe()}


if __name__ == "__main__":
    main()
