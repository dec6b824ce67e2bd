"""Topology quickstart over the PyTorch + CUDA port — cost-model placement
of 2D plans on physical axes.

A 2D SpMV scheme moves bytes in two directions: the x broadcast crosses
the mesh's *rows* axis and the partial merge crosses its *cols* axis.  On
real PIM hardware those axes are not interchangeable — one is fast
near-bank interconnect, the other crawls through host DRAM (the retrieve
bottleneck of SparseP Obs. 12).  ``repro_torch.topo`` models the physical
axes (:class:`~repro_torch.topo.DeviceTopology`), prices each axis
assignment (:class:`~repro_torch.topo.CollectiveCostModel`), and records
in ``Mesh.slots`` the device order that puts each logical axis on its
assigned links.  This script walks the whole surface on a simulated 2x2
PIM grid whose four places are the one device:

  * the cost model picks OPPOSITE assignments for a tall (merge-heavy)
    and a wide (broadcast-heavy) matrix on the same topology;
  * the placed plan computes exactly what the unplaced plan computes
    (placement changes traffic, never values), both checked vs the dense
    oracle;
  * the assignment survives a plan IR v2 round trip bit-identically.

On one card the placement is recorded and priced on the declared links;
the four parts still run in one part-axis launch.  It runs on the card
unless asked for the CPU:

    PYTHONPATH=src python examples/torch_topo_quickstart.py [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch.api import SparseMatrix, plan_from_ir
from repro_torch.api.plan import check_device
from repro_torch.topo import CollectiveCostModel, FakeTopology


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    # --- 1. a physical topology: fast bank axis, slow through-host axis --

    topo = FakeTopology.pim_like((2, 2), devices=[device] * 4)
    model = CollectiveCostModel(topo)
    print(f"topology {topo.name}: axes {topo.axis_names}, "
          f"bandwidths {[f'{l.bandwidth:.0e}' for l in topo.links]} B/s")

    # --- 2. shape decides the placement ----------------------------------

    rng = np.random.default_rng(0)
    picks, out = {}, {"plans": {}}
    for name, shape in (("tall", (512, 128)), ("wide", (128, 512))):
        a = rng.standard_normal(shape).astype(np.float32)
        a[np.abs(a) < 1.2] = 0.0
        sm = SparseMatrix.from_dense(a)
        plan = sm.plan(scheme="2d.equally-sized", grid=(2, 2), topology=topo)
        assert plan.topo_assignment is not None
        picks[name] = plan.topo_assignment
        transfer = plan.topo_assignment["transfer"]
        print(f"{name} {shape}: {plan.scheme_id}")
        print(f"  modelled transfer: load={transfer['load_s']:.2e}s "
              f"merge={transfer['merge_s']:.2e}s")

        # placement never changes the numbers — only where the bytes travel
        x = rng.standard_normal(shape[1]).astype(np.float32)
        y = np.asarray(plan.compile()(x))
        assert np.allclose(y, a @ x, rtol=1e-4, atol=1e-4)
        unplaced = sm.plan(scheme="2d.equally-sized", grid=(2, 2),
                           devices=topo.flat_devices())
        assert np.array_equal(np.asarray(unplaced.compile()(x)), y), \
            "placement changed the answer"

        # the worst assignment is priced strictly worse on this topology
        ranked = model.rank(plan.scheme, sm.shape, 4, plan.axes)
        assert ranked[0][1]["total_s"] < ranked[-1][1]["total_s"]

        # IR v2 carries the placement: rehydrate on the same topology and
        # the mesh's device order (Mesh.slots) is identical
        ir = json.loads(json.dumps(plan.to_ir()))
        assert ir["ir_version"] == 2
        rebuilt = plan_from_ir(ir, sm, devices=topo.flat_devices(),
                               topology=topo)
        assert rebuilt.scheme_id == plan.scheme_id
        assert rebuilt.mesh.slots.tolist() == plan.mesh.slots.tolist()
        out["plans"][name] = {"scheme_id": plan.scheme_id,
                              "assignment": plan.topo_assignment,
                              "slots": plan.mesh.slots.reshape(-1).tolist(),
                              "x": x, "y": y}

    # tall is merge-heavy (merge crosses cols), wide is broadcast-heavy
    # (load crosses rows): each must route its heavy direction over the
    # fast bank axis, so the two picks are opposite
    assert picks["tall"]["physical"] != picks["wide"]["physical"]
    print("opposite placements for tall vs wide on one topology — "
          "the cost model steered the heavy direction onto the fast axis")
    print("topo quickstart OK")
    return out


if __name__ == "__main__":
    main()
