"""Subprocess body of tests/test_torch_topo.py: the JAX package's side of
everything that builds a mesh, and the cases both sides run.

It needs 4 fake devices, so it owns its process (XLA_FLAGS is set in
``main`` before jax imports; importing this module for its cases imports
numpy only).  Every result goes into the .npz file named on the command
line: metadata as one JSON string per entry, answers as arrays.  Prints
``DEVICES <n>`` first and ``TOPO SKIP`` when forcing devices failed.

    python tests/_torch_topo_runner.py OUT.npz CACHE_DIR

Cases (each under ``pim2x2``, ``FakeTopology.pim_like((2, 2))`` over the
4 devices; the JAX side runs impl="xla", the port impl="cuda"):

* ``mesh|...``: ``build_mesh`` model picks, forced assignments (object and
  dict form), the flat fallback and an abstract topology — device ids;
  ``detect_topology`` of the 4 devices and a plan under it.
* ``plan|<shape>|<fmt>|<scheme>``: ``plan(topology=)``'s pick, then
  ``|<tag>`` per forced assignment of the fitted grid (2D equally-sized,
  and 1D COO): scheme id, record, estimate, ids, answers on an
  integer-valued matrix (x and a B=3 batch); ``|f32`` the pick on a random
  float32 matrix; ``plan|bf16`` a bfloat16 pick (2-byte prices).
* ``ir|...``: a placed plan's IR v2 both ways, with and without a
  topology, and read as v1.
* ``tune|...``: candidates, key and record of a FakeMeasurer tune, a
  cache file written under CACHE_DIR, a measured overrule.
* ``engine|...``: ``SpmvEngine(topology=)`` register + multiply, and a
  refinement that swaps in a placed winner.
"""
import json
import os
import sys

import numpy as np

PARTS = 4
BLOCK = (8, 16)
SHAPES = {"tall": (256, 64), "wide": (64, 256)}
FORMATS = ("coo", "csr", "bcoo", "bcsr")
SCHEMES = ("2d.equally-sized", "auto", "1d.nnz")
TO_JAX = {"torch": "xla", "cuda": "pallas"}


def forced(fmt: str, scheme: str) -> bool:
    """Cases whose every assignment is also planned by force."""
    return scheme == "2d.equally-sized" or (scheme == "1d.nnz" and fmt == "coo")


def plan_cases():
    """(case id, shape name, fmt, scheme)."""
    return [(f"plan|{s}|{f}|{sch}", s, f, sch)
            for s in SHAPES for f in FORMATS for sch in SCHEMES]


def matrix(shape_name: str, integer: bool = True) -> np.ndarray:
    """A 15 %-dense matrix from a seed; integer values in -3..3, or random
    float32 (``integer=False``)."""
    m, n = SHAPES[shape_name]
    rng = np.random.default_rng([19, m, n, int(integer)])
    mask = rng.random((m, n)) < 0.15
    vals = (rng.integers(-3, 4, (m, n)) if integer
            else rng.standard_normal((m, n)))
    return (mask * vals).astype(np.float32)


def vectors(n: int, integer: bool = True):
    """(x, X with B=3) for a matrix of n columns."""
    rng = np.random.default_rng([23, n, int(integer)])
    if integer:
        return (rng.integers(-3, 4, n).astype(np.float32),
                rng.integers(-3, 4, (n, 3)).astype(np.float32))
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


def topo_record(pln) -> dict:
    """What a placed plan shows: scheme id, record, estimate, grid."""
    return {"scheme_id": pln.scheme_id, "topo": pln.topo_assignment,
            "estimate": pln.estimate, "grid": list(pln.grid),
            "is_distributed": pln.is_distributed}


def main(out_path: str, cache_dir: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={PARTS}"
    import jax

    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < PARTS:
        print("TOPO SKIP")
        return
    from repro.api import SparseMatrix, plan_from_ir
    from repro.engine import SpmvEngine
    from repro.topo import (AxisAssignment, CollectiveCostModel,
                            FakeTopology, build_mesh, detect_topology)
    from repro.tune import FakeMeasurer, Tuner, TuningCache

    devices = jax.devices()[:PARTS]
    topo = FakeTopology.pim_like((2, 2), devices=devices)
    res = {}

    def put(key, obj):
        res[key] = np.array(json.dumps(obj))

    def ids(mesh):
        return [d.id for d in mesh.devices.flat]

    # -- build_mesh --------------------------------------------------------
    for name, inten in (("cols", {"cols": 1e6, "rows": 1.0}),
                        ("rows", {"rows": 1e6, "cols": 1.0})):
        mesh, a = build_mesh(topo, (2, 2), intensity=inten)
        put(f"mesh|intensity|{name}", {"tag": a.tag, "ids": ids(mesh)})
    swapped = AxisAssignment(("rows", "cols"), (("bank",), ("host",)))
    for form, spec in (("object", swapped), ("dict", swapped.to_dict())):
        mesh, a = build_mesh(topo, (2, 2), assignment=spec)
        put(f"mesh|forced|{form}", {"tag": a.tag, "ids": ids(mesh)})
    for shape in ((2, 1), (4,), (1, 4)):
        mesh, a = build_mesh(topo, shape)
        put(f"mesh|shape|{shape}", {"tag": a and a.tag, "ids": ids(mesh)})
    mesh, a = build_mesh(FakeTopology.pim_like((2, 2)), (2, 2), devices=devices)
    put("mesh|abstract", {"tag": a.tag, "ids": ids(mesh)})
    flat = detect_topology(devices)
    a = matrix("tall")
    pln = SparseMatrix.from_dense(a).plan(topology=flat, block=BLOCK)
    put("mesh|detect", {"name": flat.name, "sizes": list(flat.axis_sizes),
                        "plan": topo_record(pln), "ids": ids(pln.mesh)})
    res["mesh|detect|y"] = np.asarray(pln.compile()(vectors(a.shape[1])[0]))

    # -- plan(topology=) -----------------------------------------------------
    for case_id, shape, fmt, scheme in plan_cases():
        a = matrix(shape)
        x, X = vectors(a.shape[1])
        sm = SparseMatrix.from_dense(a)
        pln = sm.plan(scheme=scheme, fmt=fmt, topology=topo, block=BLOCK)
        exe = pln.compile()
        put(case_id, {**topo_record(pln), "ids": ids(pln.mesh)})
        res[f"{case_id}|y"] = np.asarray(exe(x))
        res[f"{case_id}|Y"] = np.asarray(exe.batch(X))
        if forced(fmt, scheme):
            ranked = CollectiveCostModel(topo).rank(
                pln.scheme, sm.shape, sm.dtype.itemsize, pln.axes)
            put(f"{case_id}|ranked", [[a.tag, p] for a, p in ranked])
            for alt, _ in ranked:
                f = sm.plan(scheme=scheme, fmt=fmt, topology=topo, block=BLOCK,
                            assignment=alt)
                put(f"{case_id}|{alt.tag}", {**topo_record(f), "ids": ids(f.mesh)})
                res[f"{case_id}|{alt.tag}|y"] = np.asarray(f.compile()(x))
        if fmt in ("coo", "bcoo") and scheme == "2d.equally-sized":
            af = matrix(shape, integer=False)
            xf, _ = vectors(af.shape[1], integer=False)
            pf = SparseMatrix.from_dense(af).plan(scheme=scheme, fmt=fmt,
                                                   topology=topo, block=BLOCK)
            put(f"{case_id}|f32", topo_record(pf))
            res[f"{case_id}|f32|y"] = np.asarray(pf.compile()(xf))

    # bfloat16: the model prices 2-byte values (dtype_bytes = itemsize)
    import jax.numpy as jnp

    a, x = matrix("wide"), vectors(256)[0]
    bsm = SparseMatrix.from_dense(a.astype(jnp.bfloat16))
    pln = bsm.plan(scheme="2d.equally-sized", topology=topo, block=BLOCK)
    put("plan|bf16", {**topo_record(pln), "ids": ids(pln.mesh)})
    res["plan|bf16|y"] = np.asarray(
        pln.compile()(x.astype(jnp.bfloat16))).astype(np.float32)

    # -- plan IR v2, both ways -------------------------------------------------
    import repro_torch.api as T
    import repro_torch.topo as TT

    ttopo = TT.FakeTopology.pim_like((2, 2), devices=["cpu"] * PARTS)
    a = matrix("tall")
    x, _ = vectors(a.shape[1])
    sm, tsm = SparseMatrix.from_dense(a), T.SparseMatrix.from_dense(a)
    base = sm.plan(scheme="2d.equally-sized", topology=topo, block=BLOCK)
    worst, _ = CollectiveCostModel(topo).worst(base.scheme, sm.shape,
                                               sm.dtype.itemsize, base.axes)
    placed = sm.plan(scheme="2d.equally-sized", topology=topo, block=BLOCK,
                     assignment=worst)
    jir = json.loads(json.dumps(placed.to_ir()))
    put("ir|jax_ir", jir)
    for how, kw in (("flat", {}), ("topo", {"topology": topo})):
        p = plan_from_ir(jir, sm, devices=devices, **kw)
        put(f"ir|jax_read|{how}", {"scheme_id": p.scheme_id, "ids": ids(p.mesh),
                                   "ir": p.to_ir()})
        res[f"ir|jax_read|{how}|y"] = np.asarray(p.compile()(x))
    v1 = {k: v for k, v in jir.items() if k != "topo"}
    v1["ir_version"] = 1
    p = plan_from_ir(v1, sm, devices=devices, topology=topo)
    put("ir|jax_read|v1", {"scheme_id": p.scheme_id, "ids": ids(p.mesh),
                           "topo": p.topo_assignment})
    tworst = TT.AxisAssignment.from_dict(worst.to_dict())
    tir = json.loads(json.dumps(tsm.plan(
        scheme="2d.equally-sized", topology=ttopo, block=BLOCK,
        assignment=tworst).to_ir()))
    put("ir|port_ir", tir)
    for how, kw in (("flat", {}), ("topo", {"topology": topo})):
        p = plan_from_ir(tir, sm, devices=devices, **kw)
        put(f"ir|port_read|{how}", {"scheme_id": p.scheme_id, "ids": ids(p.mesh)})
        res[f"ir|port_read|{how}|y"] = np.asarray(p.compile()(x))

    # -- tuning ------------------------------------------------------------------
    scout = Tuner(measurer=FakeMeasurer(seed=1))
    result = scout.tune(sm, devices=topo.flat_devices(), topology=topo)
    put("tune|scout", {
        "key": result.key.encode(),
        "candidates": [[m.scheme_id, m.impl, list(m.grid), m.mean_s]
                       for m in result.measurements],
        "calls": scout.measurer.calls,
        "record": scout.cache.get(result.key),
        "best": topo_record(result.best)})
    path = os.path.join(cache_dir, "topo_tune.json")
    Tuner(measurer=FakeMeasurer(seed=1), cache=TuningCache(path=path)).tune(
        sm, devices=topo.flat_devices(), topology=topo)
    placed_calls = [c for c in scout.measurer.calls if "@" in c]
    target = placed_calls[-1]
    won = Tuner(measurer=FakeMeasurer(costs={target: 1e-9})).tune(
        sm, devices=topo.flat_devices(), topology=topo)
    put("tune|overrule", {"target": target, "best": topo_record(won.best),
                          "ids": ids(won.best.mesh)})
    hit = Tuner(measurer=FakeMeasurer(seed=1), cache=TuningCache(path=path)).tune(
        sm, devices=topo.flat_devices(), topology=topo)
    put("tune|hit", {"from_cache": hit.from_cache,
                     "best": topo_record(hit.best), "ids": ids(hit.best.mesh)})

    # -- the engine ------------------------------------------------------------
    for shape in SHAPES:
        a = matrix(shape)
        x, X = vectors(a.shape[1])
        eng = SpmvEngine(topology=topo)
        entry = eng.register("m", a)
        cp = eng.plan_for("m")
        put(f"engine|{shape}", {"key": list(entry.cache_key),
                                "devices": len(eng.devices), "ids": ids(cp.mesh)})
        res[f"engine|{shape}|y"] = np.asarray(eng.multiply("m", x))
        res[f"engine|{shape}|Y"] = np.asarray(eng.multiply("m", X))
    eng = SpmvEngine(topology=topo, tuner=Tuner(
        measurer=FakeMeasurer(costs={target: 1e-9})))
    eng.register("m", matrix("tall"))
    event = eng.refine("m", x=vectors(64)[0])
    entry = eng.registry.get("m")
    put("engine|refine", {"event": event, "key": list(entry.cache_key),
                          "ids": ids(eng.plan_for("m").mesh)})
    res["engine|refine|y"] = np.asarray(eng.multiply("m", vectors(64)[0]))

    np.savez(out_path, **res)
    print("TOPO DONE")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
