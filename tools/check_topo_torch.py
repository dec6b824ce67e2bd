#!/usr/bin/env python
"""Topology-placed 2D plans on the card: the H100 gate of the PyTorch +
CUDA port.

For each container format it plans ``"2d.equally-sized"`` on a simulated
:class:`repro_torch.topo.FakeTopology` ``pim_like((2, 2))`` whose four
places are the one card, with ``impl="cuda"`` (the hand-written kernels,
one part-axis launch a request), runs it, and requires its answer to
equal the ``impl="torch"`` plan's (the plain oracles) bit for bit on
integer-valued inputs, for which float32 sums are exact in any order.
It also requires the topology's pick to be recorded on the plan and the
kernel's launch counter to move.  All four formats are gated: the CUDA
kernels take COO/CSR and BCOO/BCSR alike.

    PYTHONPATH=src python tools/check_topo_torch.py            # on the card
    PYTHONPATH=src python tools/check_topo_torch.py --device cpu

With ``--device cpu`` only the ``torch`` impl runs, against the dense
oracle, as a smoke check of the placement (a kernel wrapper on a CPU
tensor runs its plain version, which is not the kernel).

Exit status: 0 clean, 1 when a format fails.
"""
import argparse
import sys

import numpy as np

FORMATS = ("coo", "csr", "bcoo", "bcsr")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--formats", nargs="*", default=list(FORMATS),
                    help="container formats to check (default: all four)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import SparseMatrix
    from repro_torch.api.plan import check_device
    from repro_torch.data.matrices import regular_matrix
    from repro_torch.kernels import instrument
    from repro_torch.topo import FakeTopology

    device = check_device(args.device)
    on_card = device.type == "cuda"
    topo = FakeTopology.pim_like((2, 2), devices=[device] * 4)
    a = np.round(regular_matrix(args.rows, args.cols, 5, seed=0) * 2.0)
    sm = SparseMatrix.from_dense(a)
    X = np.random.default_rng(0).integers(-2, 3, (args.cols, 4)).astype(np.float32)
    want = (a @ X).astype(np.float32)

    failures = []
    for fmt in args.formats:
        ref = sm.plan(scheme="2d.equally-sized", fmt=fmt, impl="torch",
                      topology=topo)
        tag = ref.scheme_id
        if ref.topo_assignment is None:
            print(f"[FAIL] {tag}: topology pick missing")
            failures.append(fmt)
            continue
        try:
            y_ref = ref.compile().batch(X)
            if not np.array_equal(y_ref, want):
                raise AssertionError("torch plan differs from the dense oracle")
            if on_card:
                plan = sm.plan(scheme="2d.equally-sized", fmt=fmt, impl="cuda",
                               topology=topo)
                kind = "bcoo" if fmt.startswith("b") else "coo"
                before = instrument.launches(kind)
                exe = plan.compile()
                y = np.stack([exe(X[:, j]) for j in range(X.shape[1])], 1)
                Y = exe.batch(X)
                launched = instrument.launches(kind) - before
                if plan.mesh.slots.tolist() != ref.mesh.slots.tolist():
                    raise AssertionError("cuda and torch plans placed apart")
                if not (np.array_equal(y, y_ref) and np.array_equal(Y, y_ref)):
                    raise AssertionError("cuda plan differs from the torch plan")
                if launched != X.shape[1] + 1:
                    raise AssertionError(f"{launched} {kind} launches, "
                                         f"want {X.shape[1] + 1}")
        except Exception as e:  # noqa: BLE001 - every failure is reported
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:160]}")
            failures.append(fmt)
            continue
        slots = ref.mesh.slots.reshape(-1).tolist()
        what = ("cuda == torch bit for bit, " if on_card
                else "torch only (no card), ")
        print(f"[ok] {tag}: {what}slots {slots}")

    print(f"\n{len(args.formats)} formats run on {topo.name} ({device}): "
          f"{len(failures)} failures")
    if failures:
        print(f"FAIL — {', '.join(failures)}")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
