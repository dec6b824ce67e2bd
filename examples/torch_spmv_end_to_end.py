"""End-to-end partitioned SpMV over the PyTorch + CUDA port — the paper's
full pipeline (Fig. 4) on P parts, driven through repro_torch.api:
partition -> place -> load(x) -> kernel -> merge -> assemble, all behind
``plan(...).compile()``.

The P parts (``--parts``, default 8) all lie on the one device
(``devices=[device] * P``): each request runs the per-part kernel for all
parts in one part-axis launch and the merge as tensor operations on the
part axis.  It runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_spmv_end_to_end.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import SparseMatrix, plan_from_partitioned
from repro_torch.api.plan import check_device
from repro_torch.core import distributed as D
from repro_torch.data import paper_large_suite


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parts", type=int, default=8,
                    help="parts, all on the one device (even)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    n_dev = args.parts
    devices = [device] * n_dev

    print(f"parts: {n_dev} on {device}")
    spec = paper_large_suite(1)[11]  # web-Google miniature (scale-free)
    a = spec.build()
    sm = SparseMatrix.from_dense(a)
    st = sm.stats
    x = np.random.default_rng(0).standard_normal(sm.cols).astype(np.float32)
    y_ref = a @ x
    print(f"{spec.name}: {st.rows}x{st.cols} nnz={st.nnz} "
          f"({'scale-free' if st.is_scale_free else 'regular'})")
    out = {"matrix": spec.name}

    # ---- 1D: broadcast x, element-granular nnz balance -------------------
    exe1 = sm.plan(scheme="1d.nnz", devices=devices).compile()
    err = float(np.abs(exe1(x) - y_ref).max())
    print(f"1D COO.nnz     pad_eff={exe1.part.padding_efficiency:.3f} "
          f"max|err|={err:.2e}")
    out["1d"] = {"pad_eff": exe1.part.padding_efficiency, "err": err}

    # ---- 1D ring: x in per-source-shard buckets (beyond paper); its
    # schedule runs the plain torch local kernel, as the reference's runs
    # XLA's --------------------------------------------------------------
    part_r, counts = D.bucket_by_source_shard(exe1.part, n_dev)
    ring = plan_from_partitioned(part_r, exe1.mesh, ring=True,
                                 ring_counts=counts, matrix=sm).compile()
    err = float(np.abs(ring(x) - y_ref).max())
    print(f"1D ring        per-source-shard buckets    max|err|={err:.2e}")
    out["ring"] = {"pad_eff": part_r.padding_efficiency, "err": err}

    # ---- 2D equally-sized: sharded x, partials merged on the part axis ---
    exe2 = sm.plan(scheme="2d.equally-sized", grid=(n_dev // 2, 2),
                   devices=devices).compile()
    err = float(np.abs(exe2(x) - y_ref).max())
    print(f"2D equally-sized/psum_scatter              max|err|={err:.2e}")
    out["2d"] = {"pad_eff": exe2.part.padding_efficiency, "err": err,
                 "grid": tuple(exe2.part.grid)}

    # ---- power iteration: SpMV as the inner loop of a real workload ------
    sq = min(a.shape)
    a_sq = a[:sq, :sq] + np.eye(sq, dtype=np.float32) * 0.1
    exe_sq = SparseMatrix.from_dense(a_sq).plan(
        scheme="1d.nnz", devices=devices).compile()
    v = np.ones(sq, np.float32) / np.sqrt(sq)
    for _ in range(10):
        y = exe_sq(v)
        v = y / np.linalg.norm(y)
    lam = float(v @ (a_sq @ v))
    print(f"power iteration: dominant eigenvalue ~ {lam:.4f}")
    out["eigenvalue"] = lam
    return out


if __name__ == "__main__":
    main()
