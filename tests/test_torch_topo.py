"""repro_torch.topo and topology-aware placement against repro.topo.

Two tiers, the same seeded numpy inputs through both packages:

* In process (no mesh): every unit case of tests/test_topo.py — links,
  assignments, ``device_order`` over ints, the detector, the cost model
  and ``fit_plan`` with an abstract topology — run through both packages,
  results and error messages compared exactly; and ``fit_plan`` under
  ``pim_like((2, 2))`` / ``pim_like((4, 4))`` at chip_smoke.py's shapes
  (phase 3's full width and phase 13's), so the grids the card runs are
  held against the JAX package here.
* Against the JAX package on 4 fake devices in a subprocess
  (tests/_torch_topo_runner.py, once per module): ``build_mesh``,
  ``plan(topology=)`` model picks and every forced assignment on
  COO/CSR/BCOO/BCSR, the plan IR v2 in both directions (with and without a
  topology, and read as v1), the tuner's candidates and records, a
  JAX-written topology-keyed cache, and ``SpmvEngine(topology=)``.  The
  port's 4 parts lie on the CPU; ``Mesh.slots`` is compared with the JAX
  mesh's device ids.

Metadata — prices, grids, tags, scheme ids, IR dicts, tune keys — must be
equal, not close.  Answers are bit-equal on integer-valued inputs and
within rtol=atol=2e-4 (tests/test_kernels.py's tolerance) on random f32.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.topo as jtopo
import repro.tune as jtune
import repro_torch.tune as ttune
import repro_torch.topo as ttopo
from repro.api import SparseMatrix as JSparseMatrix
from repro.api.plan import fit_plan as j_fit_plan
from repro.core import formats as JF
from repro.core.adaptive import Plan as JPlan
from repro.core.spmv import spmv as j_spmv
from repro.topo.topology import HOST_LINK as J_HOST_LINK
from repro.topo.topology import ICI_LINK as J_ICI_LINK
from repro_torch.api import SparseMatrix, plan_from_ir
from repro_torch.api.plan import fit_plan as t_fit_plan
from repro_torch.cluster.worker import WorkerConfig, _WorkerState
from repro_torch.core import formats as TF
from repro_torch.core.adaptive import Plan as TPlan
from repro_torch.core.mesh import make_mesh
from repro_torch.core.spmv import spmv as t_spmv
from repro_torch.engine import SpmvEngine
from repro_torch.topo.topology import HOST_LINK as T_HOST_LINK
from repro_torch.topo.topology import ICI_LINK as T_ICI_LINK

from _torch_common import BF16, np_of, rand_sparse
from _torch_topo_runner import (BLOCK, PARTS, SHAPES, TO_JAX, forced, matrix,
                                plan_cases, vectors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * PARTS
# chip_smoke.py's regular / block sides: phase 3's, and phase 13's
# (``SMALL_ROWS``: its regular and scale-free matrices, and its block one)
FULL_WIDTH = (1 << 21, 1 << 20, 1 << 18, 1 << 17)

# one namespace per package, so each case runs unchanged on either
J = types.SimpleNamespace(
    pkg="jax", LinkSpec=jtopo.LinkSpec, AxisAssignment=jtopo.AxisAssignment,
    DeviceTopology=jtopo.DeviceTopology, FakeTopology=jtopo.FakeTopology,
    CollectiveCostModel=jtopo.CollectiveCostModel, ICI=J_ICI_LINK,
    HOST=J_HOST_LINK, Plan=JPlan, fit_plan=j_fit_plan)
T = types.SimpleNamespace(
    pkg="port", LinkSpec=ttopo.LinkSpec, AxisAssignment=ttopo.AxisAssignment,
    DeviceTopology=ttopo.DeviceTopology, FakeTopology=ttopo.FakeTopology,
    CollectiveCostModel=ttopo.CollectiveCostModel, ICI=T_ICI_LINK,
    HOST=T_HOST_LINK, Plan=TPlan, fit_plan=t_fit_plan)


def norm(obj):
    """A result of either package as plain data (exact floats kept)."""
    if isinstance(obj, (J.AxisAssignment, T.AxisAssignment)):
        return ("assignment", obj.logical, obj.physical)
    if isinstance(obj, (J.LinkSpec, T.LinkSpec)):
        return ("link", obj.bandwidth, obj.latency)
    if isinstance(obj, (J.Plan, T.Plan)):
        return ("plan", obj.partitioning, obj.scheme, obj.fmt, obj.merge,
                tuple(obj.grid), obj.reason)
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm(v) for v in obj)
    return obj


def outcome(fn):
    """("ok", result) or ("raise", exception type, message)."""
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # compared across packages, type and message
        return ("raise", type(e).__name__, str(e))


def pim(ns, devices=None):
    return ns.FakeTopology.pim_like((2, 2), devices=devices)


def plan2d(ns, merge="psum_scatter", grid=(2, 2)):
    return ns.Plan("2d", "equally-sized", "coo", merge, grid, "t")


# ------------------------------------------------------------- unit tier

UNIT = {
    "linkspec": lambda ns: [
        outcome(lambda: ns.LinkSpec(bandwidth=1e9, latency=0.0)),
        outcome(lambda: ns.LinkSpec(bandwidth=0.0, latency=1e-6)),
        outcome(lambda: ns.LinkSpec(bandwidth=1e9, latency=-1e-6))],
    "assignment_tag_group_dict": lambda ns: (lambda a: [
        a.tag, a.group("cols"), outcome(lambda: a.group("parts")), a.to_dict(),
        ns.AxisAssignment.from_dict(a.to_dict()) == a,
        hash(a) == hash(ns.AxisAssignment.from_dict(a.to_dict()))])(
            ns.AxisAssignment(("rows", "cols"), (("host",), ("bank",)))),
    "assignment_empty_group_arity": lambda ns: [
        ns.AxisAssignment(("rows", "cols"), ((), ("host", "bank"))).tag,
        outcome(lambda: ns.AxisAssignment(("rows",), (("a",), ("b",))))],
    "topology_validation": lambda ns: [outcome(f) for f in (
        lambda: ns.DeviceTopology((), (), ()),
        lambda: ns.DeviceTopology(("a", "a"), (2, 2), (ns.ICI, ns.ICI)),
        lambda: ns.DeviceTopology(("a", "b"), (2,), (ns.ICI, ns.ICI)),
        lambda: ns.DeviceTopology(("a", "b"), (2, 0), (ns.ICI, ns.ICI)),
        lambda: ns.DeviceTopology(("a", "b"), (2, 2), (ns.ICI, 1e9)),
        lambda: ns.DeviceTopology(("a", "b"), (2, 2), (ns.ICI, ns.ICI),
                                  devices=[0, 1, 2]))],
    "topology_inspection": lambda ns: (lambda t: [
        t.n_devices, t.axis_size("bank"), t.link("host"),
        outcome(lambda: t.link("ring")), t.flat_devices(), repr(t), t.name,
        t.axis_names, t.axis_sizes, t.links])(pim(ns)),
    "assignments_pim_2x2": lambda ns: [
        pim(ns).assignments(shape, ("rows", "cols"))
        for shape in ((2, 2), (1, 4), (4, 1), (2, 1), (8, 1))] + [
        pim(ns).assignments((4,), ("parts",)),
        outcome(lambda: pim(ns).assignments((2, 2), ("rows",)))],
    "device_order": lambda ns: (lambda t, a, b: [
        t.device_order(a), t.device_order(b),
        ns.FakeTopology((2, 2, 2), devices=list(range(8))).device_order(
            ns.AxisAssignment(("rows", "cols"), (("ax2", "ax0"), ("ax1",))))])(
        pim(ns, devices=list(range(4))),
        ns.AxisAssignment(("rows", "cols"), (("host",), ("bank",))),
        ns.AxisAssignment(("rows", "cols"), (("bank",), ("host",)))),
    "device_order_abstract": lambda ns: (lambda a: [
        outcome(lambda: pim(ns).device_order(a)),
        pim(ns).device_order(a, devices=range(4)),
        outcome(lambda: pim(ns).device_order(a, devices=[0, 1]))])(
        ns.AxisAssignment(("rows", "cols"), (("bank",), ("host",)))),
    "fake_defaults_and_pim_preset": lambda ns: [
        ns.FakeTopology((2, 2)).axis_names, ns.FakeTopology((2, 2)).links,
        ns.FakeTopology((2, 2)).name, pim(ns).links, pim(ns).name,
        ns.FakeTopology.pim_like((4, 4)).name,
        outcome(lambda: ns.FakeTopology.pim_like((2, 2, 2)))],
    "group_cost": lambda ns: (lambda m: [
        m.group_cost((), 1e9), m.group_cost(("bank",), 1000.0),
        m.group_cost(("host",), 1000.0), m.group_cost(("host", "bank"), 1000.0),
        m.group_cost(("bank", "host"), 3.0e6),
        ns.CollectiveCostModel(ns.FakeTopology(
            (1, 4), axis_names=("one", "many"))).group_cost(("one",), 1000.0)])(
        ns.CollectiveCostModel(pim(ns))),
    "traffic": lambda ns: (lambda m: [
        m.traffic(plan2d(ns), (64, 128), 4),
        m.traffic(plan2d(ns, merge="global"), (64, 128), 4),
        m.traffic(ns.Plan("1d", "nnz", "coo", "ppermute", (4, 1), "t"),
                  (64, 128), 4),
        m.traffic(plan2d(ns), (63, 129), 2)])(ns.CollectiveCostModel(pim(ns))),
    "rank_best_worst": lambda ns: (lambda m: [
        m.rank(plan2d(ns), (2048, 128), 4, ("rows", "cols")),
        m.best(plan2d(ns), (128, 2048), 4, ("rows", "cols")),
        m.worst(plan2d(ns), (128, 2048), 4, ("rows", "cols")),
        m.rank(plan2d(ns, merge="global"), (500, 700), 2, ("rows", "cols")),
        m.rank(plan2d(ns, merge="psum", grid=(8, 1)), (64, 128), 4,
               ("rows", "cols")),
        m.best(plan2d(ns, merge="psum", grid=(8, 1)), (64, 128), 4,
               ("rows", "cols")),
        m.rank(ns.Plan("1d", "nnz", "coo", "ppermute", (4, 1), "t"),
               (64, 128), 4, ("parts", "ignored"))])(
        ns.CollectiveCostModel(pim(ns))),
    "fit_plan_topology": lambda ns: (lambda flat, seed: [
        ns.fit_plan(seed, (64, 4096), 4, (8, 16)),
        ns.fit_plan(seed, (64, 4096), 4, (8, 16), topology=flat),
        ns.fit_plan(seed, (4096, 64), 4, (8, 16), topology=flat),
        ns.fit_plan(seed, (4096, 64), 4, (8, 16), topology=pim(ns)),
        ns.fit_plan(seed, (64, 4096), 4, (8, 16), topology=pim(ns),
                    dtype_bytes=2),
        ns.fit_plan(dataclasses.replace(seed, grid=(2, 2)), (64, 4096), 4,
                    (8, 16), topology=pim(ns))])(
        ns.DeviceTopology(("flat",), (4,), (ns.HOST,), name="flat4"),
        ns.Plan("2d", "equally-sized", "coo", "psum", (), "r")),
}


@pytest.mark.parametrize("case", sorted(UNIT))
def test_unit_case_matches_jax(case):
    assert norm(UNIT[case](T)) == norm(UNIT[case](J))


def test_link_constants_and_names_are_the_references():
    assert norm(T_ICI_LINK) == norm(J_ICI_LINK)
    assert norm(T_HOST_LINK) == norm(J_HOST_LINK)
    assert ttopo.__all__ == jtopo.__all__
    pim16 = T.FakeTopology.pim_like((4, 4))
    assert (pim16.name, pim16.axis_sizes) == ("pim4x4", (4, 4))


def test_detect_topology_is_the_references_flat_answer(monkeypatch):
    jflat = jtopo.detect_topology(jax.devices())
    tflat = ttopo.detect_topology(["cpu"] * jax.device_count())
    for attr in ("name", "axis_names", "axis_sizes"):
        assert getattr(tflat, attr) == getattr(jflat, attr)
    assert norm(tflat.links) == norm(jflat.links) == (norm(J_HOST_LINK),)
    assert len(tflat.flat_devices()) == len(jflat.flat_devices())
    many = ttopo.detect_topology(["cuda"] * 16)
    assert (many.name, many.axis_sizes) == ("cuda:flat", (16,))
    assert ttopo.detect_topology(["cpu"] * 4).name == "cpu:flat"
    for pkg in (jtopo, ttopo):
        with pytest.raises(ValueError, match="no devices"):
            pkg.detect_topology([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttopo.detect_topology()  # no card: never falls back to the CPU


FULL_SCHEMES = ("2d.equally-sized", "2d.equally-wide", "2d.variable-sized",
                "1d")


@pytest.mark.parametrize("shape2d", [(2, 2), (4, 4)])
@pytest.mark.parametrize("side", FULL_WIDTH)
@pytest.mark.parametrize("scheme", FULL_SCHEMES)
def test_full_width_grid_choices_match_jax(shape2d, side, scheme):
    """The grids and placements phase 13 of chip_smoke.py runs on the card,
    chosen here by both packages: fit_plan's pick, then the ranking of its
    assignments, for COO and the block format, at f32 and bf16 widths."""
    n = shape2d[0] * shape2d[1]
    got = {}
    for ns in (T, J):
        topo = ns.FakeTopology.pim_like(shape2d)
        model = ns.CollectiveCostModel(topo)
        rows = []
        for fmt in ("coo", "bcoo"):
            if scheme == "1d":
                seed = ns.Plan("1d", "nnz", fmt, "ppermute", (n, 1), "r")
            else:
                sub = scheme.split(".")[1]
                merge = "psum_scatter" if sub == "equally-sized" else "global"
                seed = ns.Plan("2d", sub, fmt, merge, (), "r")
            for dtype_bytes in (4, 2):
                fitted = ns.fit_plan(seed, (side, side), n, (8, 16),
                                     topology=topo, dtype_bytes=dtype_bytes)
                axes = ("parts",) if fitted.partitioning == "1d" else ("rows",
                                                                       "cols")
                rows.append((fitted, model.rank(fitted, (side, side),
                                                dtype_bytes, axes)))
        got[ns.pkg] = norm(rows)
    assert got["port"] == got["jax"]
    assert all(ranked for _, ranked in got["port"])  # every grid lays out


def test_mesh_slots_validate():
    mesh = make_mesh((2, 2), ("rows", "cols"), CPU4)
    assert mesh.slots.tolist() == [[0, 1], [2, 3]]
    assert make_mesh((4,), ("parts",), CPU4, slots=[0, 2, 1, 3]).slots.tolist() \
        == [0, 2, 1, 3]
    with pytest.raises(ValueError, match="permutation"):
        make_mesh((2, 2), ("rows", "cols"), CPU4, slots=[0, 1, 1, 3])


def test_core_spmv_shim_matches_jax():
    a = rand_sparse(48, 64, 0.2, np.float32, seed=5, integer=True)
    x = np.random.default_rng(5).integers(-3, 4, 64).astype(np.float32)
    for fmt in ("csr", "coo", "bcsr", "bcoo"):
        kw = {"block": (8, 16)} if fmt.startswith("b") else {}
        jm = getattr(JF, f"dense_to_{fmt}")(a, **kw)
        tm = getattr(TF, f"dense_to_{fmt}")(a, **kw)
        want = np.asarray(j_spmv(jm, x))
        np.testing.assert_array_equal(np_of(t_spmv(tm, torch.from_numpy(x))),
                                      want, err_msg=fmt)


# --------------------------------------------------- against 4 JAX devices


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("topo")
    out = tmp / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_topo_runner.py"),
         str(out), str(tmp)], capture_output=True, text=True, env=env,
        timeout=600)
    if proc.returncode != 0:
        pytest.fail(f"topo runner crashed:\n{proc.stderr[-3000:]}")
    if "TOPO SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        res = {k: (json.loads(str(v)) if v.dtype.kind == "U" else v)
               for k, v in z.items()}
    res["cache_path"] = str(tmp / "topo_tune.json")
    return res


def _pim4():
    return T.FakeTopology.pim_like((2, 2), devices=CPU4)


TOPO_EST = ("topo_load_s", "topo_merge_s")


def _record(pln) -> dict:
    """tests/_torch_topo_runner.py's topo_record, JSON round-tripped, with
    the estimate's topology-priced keys only (the port's HardwareModel holds
    the H100's rates, so its Fig.-4 estimate differs by design)."""
    return json.loads(json.dumps({
        "scheme_id": pln.scheme_id, "topo": pln.topo_assignment,
        "estimate": {k: pln.estimate[k] for k in TOPO_EST if k in pln.estimate},
        "grid": list(pln.grid), "is_distributed": pln.is_distributed}))


def _want(rec: dict) -> dict:
    """A JAX topo_record as :func:`_record` shows it (no device ids)."""
    rec = {k: v for k, v in rec.items() if k != "ids"}
    rec["estimate"] = {k: rec["estimate"][k] for k in TOPO_EST
                       if k in rec["estimate"]}
    return rec


def _slots(pln):
    return pln.mesh.slots.reshape(-1).tolist()


MESH_CASES = [("mesh|intensity|cols", {"intensity": {"cols": 1e6, "rows": 1.0}}),
              ("mesh|intensity|rows", {"intensity": {"rows": 1e6, "cols": 1.0}}),
              ("mesh|forced|object", "object"), ("mesh|forced|dict", "dict"),
              ("mesh|shape|(2, 1)", (2, 1)), ("mesh|shape|(4,)", (4,)),
              ("mesh|shape|(1, 4)", (1, 4)), ("mesh|abstract", "abstract")]


@pytest.mark.parametrize("key,how", MESH_CASES, ids=[k for k, _ in MESH_CASES])
def test_build_mesh_slots_are_the_jax_device_ids(jax_side, key, how):
    swapped = T.AxisAssignment(("rows", "cols"), (("bank",), ("host",)))
    if isinstance(how, dict):
        mesh, a = ttopo.build_mesh(_pim4(), (2, 2), **how)
    elif how in ("object", "dict"):
        spec = swapped if how == "object" else swapped.to_dict()
        mesh, a = ttopo.build_mesh(_pim4(), (2, 2), assignment=spec)
    elif how == "abstract":
        mesh, a = ttopo.build_mesh(T.FakeTopology.pim_like((2, 2)), (2, 2),
                                   devices=CPU4)
    else:
        mesh, a = ttopo.build_mesh(_pim4(), how)
    want = jax_side[key]
    assert (a and a.tag) == want["tag"]
    assert mesh.slots.reshape(-1).tolist() == want["ids"]
    assert mesh.device == torch.device("cpu")


def test_build_mesh_rank3_raises_as_the_reference():
    for pkg in (jtopo, ttopo):
        with pytest.raises(ValueError, match="rank-3"):
            pkg.build_mesh(pkg.FakeTopology.pim_like((2, 2)), (2, 2, 1),
                           devices=list(range(4)) if pkg is jtopo else CPU4)


def test_plan_under_the_detector_matches_jax(jax_side):
    want = jax_side["mesh|detect"]
    flat = ttopo.detect_topology(CPU4)
    assert [flat.name, list(flat.axis_sizes)] == [want["name"], want["sizes"]]
    a = matrix("tall")
    pln = SparseMatrix.from_dense(a).plan(topology=flat, block=BLOCK)
    assert _record(pln) == _want(want["plan"]) and _slots(pln) == want["ids"]
    y = pln.compile()(vectors(a.shape[1])[0])
    np.testing.assert_array_equal(y, jax_side["mesh|detect|y"])


@pytest.mark.parametrize("case", plan_cases(), ids=lambda c: c[0])
def test_plan_topology_matches_jax(jax_side, case):
    case_id, shape, fmt, scheme = case
    topo = _pim4()
    a = matrix(shape)
    x, X = vectors(a.shape[1])
    sm = SparseMatrix.from_dense(a)
    pln = sm.plan(scheme=scheme, fmt=fmt, topology=topo, block=BLOCK)
    want = jax_side[case_id]
    assert _record(pln) == _want(want)
    assert _slots(pln) == want["ids"]
    assert "topo:" in pln.describe() and "@" in pln.scheme_id
    assert set(pln.estimate) >= {"topo_load_s", "topo_merge_s"}
    exe = pln.compile()
    np.testing.assert_array_equal(exe(x), jax_side[f"{case_id}|y"])
    np.testing.assert_array_equal(exe.batch(X), jax_side[f"{case_id}|Y"])
    if forced(fmt, scheme):
        ranked = T.CollectiveCostModel(topo).rank(
            pln.scheme, sm.shape, sm.dtype.itemsize, pln.axes)
        assert json.loads(json.dumps([[a.tag, p] for a, p in ranked])) \
            == jax_side[f"{case_id}|ranked"]
        ys = []
        for alt, _ in ranked:
            f = sm.plan(scheme=scheme, fmt=fmt, topology=topo, block=BLOCK,
                        assignment=alt)
            fwant = jax_side[f"{case_id}|{alt.tag}"]
            assert _record(f) == _want(fwant)
            assert f.scheme_id.endswith(f"@{alt.tag}")
            assert _slots(f) == fwant["ids"]
            ys.append(f.compile()(x))
            np.testing.assert_array_equal(ys[-1],
                                          jax_side[f"{case_id}|{alt.tag}|y"])
        assert len(ranked) == 2 and np.array_equal(ys[0], ys[1])
    if f"{case_id}|f32" in jax_side:
        af = matrix(shape, integer=False)
        xf, _ = vectors(af.shape[1], integer=False)
        pf = SparseMatrix.from_dense(af).plan(scheme=scheme, fmt=fmt,
                                              topology=topo, block=BLOCK)
        assert _record(pf) == _want(jax_side[f"{case_id}|f32"])
        np.testing.assert_allclose(pf.compile()(xf),
                                   jax_side[f"{case_id}|f32|y"],
                                   rtol=2e-4, atol=2e-4)


def test_bf16_plan_prices_two_byte_values_as_jax(jax_side):
    want = jax_side["plan|bf16"]
    a, x = matrix("wide"), vectors(256)[0]
    sm = SparseMatrix.from_dense(a.astype(BF16))
    pln = sm.plan(scheme="2d.equally-sized", topology=_pim4(), block=BLOCK)
    assert sm.dtype.itemsize == 2
    assert _record(pln) == _want(want) and _slots(pln) == want["ids"]
    y = np.asarray(pln.compile()(x.astype(BF16))).astype(np.float32)
    np.testing.assert_array_equal(y, jax_side["plan|bf16|y"])


def test_plan_assignment_without_topology_raises_as_the_reference():
    sm, jsm = SparseMatrix.from_dense(matrix("tall")), \
        JSparseMatrix.from_dense(matrix("tall"))
    a = T.AxisAssignment(("rows", "cols"), (("bank",), ("host",)))
    for plan, kw in ((sm.plan, {"devices": CPU4}), (jsm.plan, {})):
        with pytest.raises(ValueError, match="requires topology"):
            plan(scheme="2d.equally-sized", grid=(2, 2), assignment=a, **kw)
        with pytest.raises(ValueError, match="abstract"):
            plan(scheme="2d.equally-sized",
                 topology=jtopo.FakeTopology.pim_like((2, 2)))


def test_port_reads_a_placed_jax_ir_and_writes_it_back(jax_side):
    """The JAX package's topology-placed IR v2 read by the port with no
    topology: the "topo" record, the ``@`` scheme id and the re-emitted IR
    are the JAX package's own; with the topology the placement is laid out
    again (slots = the JAX mesh's ids)."""
    jir = jax_side["ir|jax_ir"]
    assert jir["topo"] and jir["topo"]["topology"] == "pim2x2"
    sm = SparseMatrix.from_dense(matrix("tall"))
    x, _ = vectors(64)
    for how, kw in (("flat", {}), ("topo", {"topology": _pim4()})):
        want = jax_side[f"ir|jax_read|{how}"]
        p = plan_from_ir(jir, sm, device="cpu", devices=CPU4, **kw)
        assert "@" in p.scheme_id and p.scheme_id == want["scheme_id"]
        assert p.topo_assignment == jir["topo"]
        assert json.loads(json.dumps(p.to_ir())) == want["ir"] == jir
        assert _slots(p) == want["ids"]
        np.testing.assert_array_equal(p.compile()(x),
                                      jax_side[f"ir|jax_read|{how}|y"])


def test_jax_reads_the_ports_placed_ir(jax_side):
    tir = jax_side["ir|port_ir"]
    jir = jax_side["ir|jax_ir"]
    for key in ("topo", "scheme", "mesh", "dtype", "block", "ir_version"):
        assert tir[key] == jir[key], key
    assert (tir["impl"], jir["impl"]) == ("pallas", "xla")  # default impls
    assert {k: tir["estimate"][k] for k in TOPO_EST} \
        == {k: jir["estimate"][k] for k in TOPO_EST}
    sm = SparseMatrix.from_dense(matrix("tall"))
    worst = T.AxisAssignment.from_dict(jir["topo"])
    mine = sm.plan(scheme="2d.equally-sized", topology=_pim4(), block=BLOCK,
                   assignment=worst)
    for how in ("flat", "topo"):
        want = jax_side[f"ir|port_read|{how}"]
        assert want["scheme_id"] == mine.scheme_id
        np.testing.assert_array_equal(mine.compile()(vectors(64)[0]),
                                      jax_side[f"ir|port_read|{how}|y"])
    assert jax_side["ir|port_read|topo"]["ids"] == _slots(mine)


def test_ir_v1_reads_with_no_placement(jax_side):
    jir = jax_side["ir|jax_ir"]
    v1 = {k: v for k, v in jir.items() if k != "topo"}
    v1["ir_version"] = 1
    p = plan_from_ir(v1, SparseMatrix.from_dense(matrix("tall")), device="cpu",
                     devices=CPU4, topology=_pim4())
    want = jax_side["ir|jax_read|v1"]
    assert p.scheme_id == want["scheme_id"] and "@" not in p.scheme_id
    assert p.topo_assignment is want["topo"] is None
    assert _slots(p) == want["ids"]
    assert p.to_ir()["topo"] is None and "topo:" not in p.describe()


def test_cluster_worker_keeps_the_placed_ir_id(jax_side):
    """A port worker registering the JAX package's placed IR reports its
    ``@`` scheme id, and answers as the plan does."""
    jir = jax_side["ir|jax_ir"]
    a = matrix("tall")
    state = _WorkerState(WorkerConfig("w0", impl="torch", devices=tuple(CPU4)))
    info = state.register({"name": "m", "a": a, "ir": jir})
    assert info["source"] == "ir"
    assert info["scheme_id"] == jax_side["ir|jax_read|flat"]["scheme_id"]
    x, _ = vectors(64)
    np.testing.assert_array_equal(state.engine.multiply("m", x),
                                  jax_side["ir|jax_read|flat|y"])


class PortFake(ttune.FakeMeasurer):
    """The port's FakeMeasurer hashing each candidate under its JAX impl
    name, so both packages draw the same pseudo-times."""

    def _fake_time(self, plan) -> float:
        return super()._fake_time(types.SimpleNamespace(
            scheme_id=plan.scheme_id, impl=TO_JAX[plan.impl], grid=plan.grid))


def _tuner(measurer, cache=None):
    return ttune.Tuner(generator=ttune.CandidateGenerator(impls=("torch",)),
                       measurer=measurer, cache=cache)


def _jax_impls(record: dict) -> dict:
    """A port tune record with its impl names as the JAX package's."""
    out = json.loads(json.dumps(record))
    out["impl"] = TO_JAX[out["impl"]]
    out["baseline_impl"] = TO_JAX[out["baseline_impl"]]
    for c in out["candidates"]:
        c["impl"] = TO_JAX[c["impl"]]
    return out


def test_tuner_candidates_and_record_match_jax(jax_side):
    want = jax_side["tune|scout"]
    sm = SparseMatrix.from_dense(matrix("tall"))
    scout = _tuner(PortFake(seed=1))
    result = scout.tune(sm, topology=_pim4())
    fp, pool, topo, dtype, batch, impls, block = result.key.encode().split("|")
    assert (pool, topo) == ("cpu:4", "pim2x2:2x2")
    assert "|".join([fp, pool, topo, dtype, batch, TO_JAX[impls], block]) \
        == want["key"]
    got = [[m.scheme_id, TO_JAX[m.impl], list(m.grid), m.mean_s]
           for m in result.measurements]
    assert got == want["candidates"]
    assert len([c for c in got if "@" in c[0]]) >= 2
    assert _jax_impls(scout.cache.get(result.key)) == want["record"]
    assert _record(result.best) == _want(want["best"])


def test_jax_written_topology_cache_is_found_by_the_ports_key(jax_side):
    cache = ttune.TuningCache(path=jax_side["cache_path"])
    jcache = jtune.TuningCache(path=jax_side["cache_path"])
    assert cache.load_error is None and cache.export() == jcache.export()
    [(encoded, record)] = cache.export().items()
    assert len(encoded.split("|")) == 7  # the topology part holds a "|"
    sm = SparseMatrix.from_dense(matrix("tall"))
    key = ttune.make_key(sm, impls="xla", topology=_pim4())
    assert key.encode() == encoded == jax_side["tune|scout"]["key"]
    assert cache.get(key) == record == jax_side["tune|scout"]["record"]
    assert record["topo"]["topology"] == "pim2x2"


def test_tuner_measurement_overrules_the_model_pick(jax_side):
    want = jax_side["tune|overrule"]
    scheme_id, jimpl = want["target"].rsplit("|", 1)
    sm = SparseMatrix.from_dense(matrix("tall"))
    result = _tuner(PortFake(costs={want["target"]: 1e-9})).tune(
        sm, topology=_pim4())
    assert result.best.scheme_id == scheme_id and TO_JAX[result.best.impl] == jimpl
    assert _record(result.best) == _want(want["best"])
    assert _slots(result.best) == want["ids"]


def test_tuner_cache_hit_rebuilds_the_placement(jax_side, tmp_path):
    want = jax_side["tune|hit"]
    sm = SparseMatrix.from_dense(matrix("tall"))
    path = tmp_path / "port.json"
    first = _tuner(PortFake(seed=1), ttune.TuningCache(path=path)).tune(
        sm, topology=_pim4())
    again = _tuner(PortFake(seed=1), ttune.TuningCache(path=path))
    hit = again.tune(sm, topology=_pim4())
    assert hit.from_cache is want["from_cache"] is True
    assert again.measurer.calls == []
    assert hit.best.scheme_id == first.best.scheme_id == want["best"]["scheme_id"]
    assert _record(hit.best) == _want(want["best"])
    assert _slots(hit.best) == want["ids"]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_engine_topology_serves_the_same_answers(jax_side, shape):
    want = jax_side[f"engine|{shape}"]
    a = matrix(shape)
    x, X = vectors(a.shape[1])
    eng = SpmvEngine(topology=_pim4(), impl="torch")
    entry = eng.register("m", a)
    fp, grid, dtype, tag, impl = entry.cache_key
    assert [fp, list(grid), dtype, tag, TO_JAX[impl]] == want["key"]
    assert len(eng.devices) == want["devices"]
    assert eng.plan_for("m").mesh.slots.reshape(-1).tolist() == want["ids"]
    np.testing.assert_array_equal(eng.multiply("m", x), jax_side[f"engine|{shape}|y"])
    np.testing.assert_array_equal(eng.multiply("m", X), jax_side[f"engine|{shape}|Y"])


def test_engine_refine_swaps_in_the_placed_winner(jax_side):
    """A refinement under a topology: the winner's ``@`` scheme id keys the
    engine's plan cache, as in the JAX engine, and its placement is built."""
    want = jax_side["engine|refine"]
    target = jax_side["tune|overrule"]["target"]
    eng = SpmvEngine(topology=_pim4(), impl="torch",
                     tuner=_tuner(PortFake(costs={target: 1e-9})))
    eng.register("m", matrix("tall"))
    event = eng.refine("m", x=vectors(64)[0])
    jevent = dict(want["event"])
    assert event["swapped"] is jevent["swapped"] is True
    for k in ("winner", "incumbent", "from_cache", "trigger", "batch"):
        assert event[k] == jevent[k], k
    assert TO_JAX[event["winner_impl"]] == jevent["winner_impl"]
    fp, grid, dtype, sid, impl = eng.registry.get("m").cache_key
    assert [fp, list(grid), dtype, sid, TO_JAX[impl]] == want["key"]
    assert "@" in sid
    assert eng.plan_for("m").mesh.slots.reshape(-1).tolist() == want["ids"]
    np.testing.assert_array_equal(eng.multiply("m", vectors(64)[0]),
                                  jax_side["engine|refine|y"])
