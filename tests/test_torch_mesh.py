"""The partitioned slice: repro_torch's MeshExecutor against repro's.

Same numpy inputs (tests/_torch_mesh_cases.py) through ``SparseMatrix ->
plan(devices=4 parts) -> compile -> exe`` in both packages, for every 1D /
2D / ring scheme and merge the JAX package has: the port's 4 parts lie on
the CPU, the JAX side runs on 4 fake devices in a subprocess
(tests/_torch_mesh_runner.py, once per module).  impl="torch" is held
against impl="xla" and impl="cuda" (on the CPU: the kernels' plain
versions) against impl="pallas" (interpret mode), phase by phase: the
placed x, the raw per-part outputs, the assembled y and ``exe.batch(X)``.
Integer-valued float32, int8 and bfloat16 inputs must agree bit for bit;
random float32 within rtol=atol=2e-4 (tests/test_kernels.py's tolerance:
sums run in another order).  Solver sessions (``exe.iterate``) on 4 parts:
plain, Richardson and Jacobi bit for bit with the JAX session and with the
port's host loop of ``exe(x)`` calls, power to tolerance in the same
number of steps and within 1e-5.

The same cases run once more on a process mesh: one gloo world of 4 CPU
ranks per module (``repro_torch.core.world.spawn``, bodies in
tests/_torch_world_runner.py), one part per rank.  Each rank's placed x
shard and ``run_raw`` part must equal the JAX runner's shard and part at
that rank's place, and every rank's ``assemble``, ``batch`` and solver
session must equal JAX's, under the same tolerances; the plan IR written
on the process mesh is the one the JAX runner read and ran.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import SparseMatrix, plan_from_ir, plan_from_partitioned
from repro_torch.core import distributed as D
from repro_torch.core.mesh import make_mesh
from repro_torch.core.partition import partition_1d
from repro_torch.core.world import spawn
from repro_torch.kernels import instrument

import _solver_runner as sr
from _torch_common import BF16
from _torch_mesh_cases import (BLOCK, IR_PLANS, PARTS, SOLVER_CASES, cases,
                               matrix, solver_inputs, vectors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * PARTS


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_runner.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        pytest.fail(f"mesh runner crashed:\n{proc.stderr[-3000:]}")
    if "MESH SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def world_side():
    """Every rank's results of ``_torch_world_runner.mesh_cases`` (one
    4-rank gloo world on the CPU)."""
    import _torch_world_runner as wr

    return spawn(wr.mesh_cases, PARTS, "gloo", device="cpu", timeout=300)


def _inputs(dtype):
    a = matrix(dtype)
    x, X = vectors(dtype)
    if dtype == "bf16":
        a, x, X = a.astype(BF16), x.astype(BF16), X.astype(BF16)
    return a, x, X


def _host(t) -> np.ndarray:
    """A result as numpy, bfloat16 (tensor or ml_dtypes) widened to f32."""
    if isinstance(t, torch.Tensor):
        t = t.float() if t.dtype == torch.bfloat16 else t
        return t.cpu().numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype == BF16 else t


def _same(got, want, exact: bool, what: str):
    got, want = _host(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=what)


def _port_plan(plan, impl, dtype, sm, a):
    _, scheme, fmt, merge, grid, ring = plan
    if ring:
        part = partition_1d(a, PARTS, fmt=fmt, balance=scheme.split(".")[1],
                            block=BLOCK)
        part_r, counts = D.bucket_by_source_shard(part, PARTS)
        mesh = make_mesh((PARTS,), ("parts",), CPU4)
        return plan_from_partitioned(part_r, mesh, impl=impl, ring=True,
                                     ring_counts=counts, matrix=sm)
    return sm.plan(scheme=scheme, fmt=fmt, merge=merge, grid=grid, impl=impl,
                   devices=CPU4, block=BLOCK)


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_mesh_executor_matches_jax(jax_side, case):
    case_id, plan, dtype, (impl, _) = case
    want = {k.split("|", 1)[1]: v for k, v in jax_side.items()
            if k.startswith(case_id + "|")}
    a, x, X = _inputs(dtype)
    sm = SparseMatrix.from_dense(a)
    pln = _port_plan(plan, impl, dtype, sm, a)
    assert pln.is_distributed and pln.device.type == "cpu"
    assert pln.scheme_id == str(want["scheme_id"])
    exact = dtype != "rand"
    instrument.reset()
    exe = pln.compile()
    xs = exe.place(x)
    _same(xs, want["place"], True, "place")
    raw = exe.run_raw(xs)
    _same(raw.y_parts, want["raw"], exact, "run_raw")
    y = exe.assemble(raw)
    _same(y, want["y"], exact, "assemble")
    Y = exe.batch(X)
    _same(Y, want["Y"], exact, "batch")
    # host rows come back in the JAX executor's dtype (bfloat16 included)
    assert (y.dtype.name, Y.dtype.name) == (str(want["y_dtype"]),
                                            str(want["Y_dtype"]))
    np.testing.assert_array_equal(exe(x), y)  # the three phases == exe(x)
    assert instrument.launches() == 0  # CPU tensors: the plain versions


@pytest.mark.parametrize("ir_plan", IR_PLANS, ids=lambda p: p[0])
def test_mesh_plan_ir_is_read_across_both_packages(jax_side, ir_plan):
    name, scheme, fmt, impl = ir_plan
    a, x, _ = _inputs("f32")
    sm = SparseMatrix.from_dense(a)
    # JAX -> port: the recorded 4-part mesh is laid on the CPU
    jir = json.loads(str(jax_side[f"{name}|jax_ir"]))
    tp = plan_from_ir(jir, sm, device="cpu")
    assert tp.is_distributed and tp.impl == impl
    assert tp.mesh.devices.shape == tuple(jir["mesh"]["shape"])
    assert tp.mesh.axis_names == tuple(jir["mesh"]["axes"])
    np.testing.assert_array_equal(tp.compile()(x), jax_side[f"{name}|jax_y"])
    assert tp.to_ir()["mesh"] == jir["mesh"]
    # port -> JAX: the runner read the port's IR and ran it
    tir = json.loads(json.dumps(sm.plan(scheme=scheme, fmt=fmt, impl=impl,
                                        devices=CPU4, block=BLOCK).to_ir()))
    assert tir == json.loads(str(jax_side[f"{name}|port_ir"]))
    assert str(jax_side[f"{name}|port_ir_scheme_id"]) == tp.scheme_id
    np.testing.assert_array_equal(tp.compile()(x),
                                  jax_side[f"{name}|port_ir_y"])


def test_mesh_executor_surface():
    a, x, X = _inputs("f32")
    sm = SparseMatrix.from_dense(a)
    pln = sm.plan(scheme="1d.nnz", devices=CPU4)
    exe = pln.compile()
    assert exe.trace_count == 1 and exe.build_seconds > 0
    assert exe.x_spec == ("parts",) and exe.x_pad == 128
    exe.warmup()
    exe(x), exe.batch(X)
    assert exe.trace_count == 1  # requests build nothing
    with pytest.raises(ValueError, match="cols, B"):
        exe.batch(x)
    with pytest.raises(ValueError, match="128 cols"):
        exe(np.ones(100, np.float32))
    exe.release()
    exe.release()  # idempotent
    with pytest.raises(RuntimeError, match="released"):
        exe(x)
    with pytest.raises(ValueError, match="single-device"):
        sm.plan(device="cpu").program()
    assert isinstance(pln.program(), D.PartitionedProgram)
    ring = plan_from_partitioned(
        D.bucket_by_source_shard(partition_1d(a, PARTS), PARTS)[0],
        make_mesh((PARTS,), ("parts",), CPU4), impl="cuda", ring=True,
        ring_counts=np.ones((PARTS, PARTS), np.int64))
    with pytest.raises(ValueError, match="torch local"):
        ring.compile()
    with pytest.raises(ValueError, match="serialized"):
        ring.to_ir()


def test_ring_plan_ir_fields_are_read():
    """A ring record rehydrates as a ring plan (its counts kept) on a mesh
    of the one device it is given, and writes the same fields back."""
    a, _, _ = _inputs("f32")
    sm = SparseMatrix.from_dense(a)
    ir = json.loads(json.dumps(sm.plan(scheme="1d.nnz", impl="torch",
                                       devices=CPU4).to_ir()))
    counts = np.arange(PARTS * PARTS).reshape(PARTS, PARTS)
    ir.update(ring=True, ring_counts=counts.tolist())
    pln = plan_from_ir(ir, sm, device="cpu")
    assert pln.ring and pln.scheme_id == "1d.nnz.coo.ppermute.ring"
    np.testing.assert_array_equal(pln.ring_counts, counts)
    assert pln.mesh.devices.shape == (PARTS,) and pln.impl == "torch"
    back = pln.to_ir()
    assert back["ring"] and back["ring_counts"] == counts.tolist()
    assert back["mesh"] == {"shape": [PARTS], "axes": ["parts"]}


@pytest.mark.parametrize("scheme,fmt", [("1d.nnz", "coo"), ("1d.rows", "csr"),
                                        ("2d.variable-sized", "coo"),
                                        ("2d.equally-sized", "bcoo"),
                                        ("2d.equally-wide", "bcsr")])
def test_part_axis_call_equals_its_per_part_plain_versions(scheme, fmt):
    """The local kernel's one part-axis call (on the CPU: the stacked plain
    version) equals the plain version run part by part on each part's own
    arrays and x window."""
    a, x, X = _inputs("rand")
    exe = SparseMatrix.from_dense(a).plan(scheme=scheme, fmt=fmt,
                                          devices=CPU4, block=BLOCK).compile()
    local, arrs = exe.program.local, D._flat(exe.arrays) \
        if exe.plan.partitioning == "2d" else exe.arrays
    for v in (x, X):
        xb = exe.program.x_buffer(exe.place(v))
        got = local.raw(arrs, xb)
        assert got.shape[:2] == (PARTS, exe.part.h_pad)
        for p in range(PARTS):
            xp = xb if local.windows is None else local.windows.local(xb, p)
            if local.scalar:
                one = D.ChunkPlan(**{k: arrs[f"chunk_{k}"][p] for k in (
                    "rowind", "colind", "values", "window", "count",
                    "window_start")}, n_windows=local.n_windows,
                    out_rows=exe.part.h_pad, span=local.span)
                want = D.coo_spmv_plain(one, xp)
            else:
                want = D.bcoo_spmv_plain(arrs["rowind"][p], arrs["colind"][p],
                                         arrs["values"][p], xp, exe.part.h_pad,
                                         arrs["nnz"][p])
            assert torch.equal(got[p], want)


@pytest.mark.parametrize("case", SOLVER_CASES, ids=lambda c: c[0])
def test_mesh_solver_session_matches_jax(jax_side, case):
    case_id, scheme, fmt, combine, (impl, _) = case
    want = {k.split("|", 1)[1]: v for k, v in jax_side.items()
            if k.startswith(case_id + "|")}
    a, x0, kw = solver_inputs(combine)
    pln = SparseMatrix.from_dense(a).plan(scheme=scheme, fmt=fmt, impl=impl,
                                          devices=CPU4, block=BLOCK)
    assert pln.is_distributed and pln.scheme_id == str(want["scheme_id"])
    exe = pln.compile()
    instrument.reset()
    res = exe.iterate(x0, **kw)
    assert instrument.launches() == 0  # CPU tensors: the plain versions
    assert res.steps == int(want["steps"])
    assert res.converged == bool(want["converged"])
    if combine == "power-tol":
        assert res.converged and res.steps % kw["check_every"] == 0
        np.testing.assert_allclose(res.x, want["x"], rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_array_equal(res.x, want["x"])
    np.testing.assert_array_equal(
        res.x, sr.host_loop(exe, x0, kw["steps"], combine,
                            b=kw.get("b"), diag=kw.get("diag"),
                            omega=kw.get("omega", 1.0)))


def _at_place(want: np.ndarray, mesh_shape, coords) -> np.ndarray:
    """The JAX runner's per-part output at one rank's place (a replicated
    output, the 2D global buffer, is every rank's)."""
    if want.shape[:len(mesh_shape)] != tuple(mesh_shape):
        return want
    return want[tuple(slice(c, c + 1) for c in coords)]


def _x_shard(want: np.ndarray, mesh_shape, coords) -> np.ndarray:
    """A rank's shard of the JAX runner's placed x: over the parts (1D),
    over the columns (2D)."""
    axis = 0 if len(mesh_shape) == 1 else 1
    w = want.shape[0] // mesh_shape[axis]
    return want[coords[axis] * w: (coords[axis] + 1) * w]


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_process_mesh_matches_jax(jax_side, world_side, case):
    """One part per rank of a 4-rank gloo world, against the JAX package's
    4 devices: each rank's x shard and part, and every rank's y."""
    case_id, _, dtype, _ = case
    want = {k.split("|", 1)[1]: v for k, v in jax_side.items()
            if k.startswith(case_id + "|")}
    exact = dtype != "rand"
    for rank, res in enumerate(world_side):
        got = {k.split("|", 1)[1]: v for k, v in res.items()
               if k.startswith(case_id + "|")}
        shape, coords = got["mesh"]
        what = f"rank {rank} at {coords} of {shape}"
        assert int(np.prod(shape)) == PARTS and got["device"] == "cpu"
        assert got["scheme_id"] == str(want["scheme_id"])
        _same(got["place"], _x_shard(want["place"], shape, coords), True,
              f"place, {what}")
        _same(got["raw"], _at_place(want["raw"], shape, coords), exact,
              f"run_raw, {what}")
        _same(got["y"], want["y"], exact, f"assemble, {what}")
        _same(got["Y"], want["Y"], exact, f"batch, {what}")
        assert got["dtypes"] == (str(want["y_dtype"]), str(want["Y_dtype"]))
        assert got["call_is_phases"]  # exe(x) == the three phases
        assert got["launches"] == 0  # CPU tensors: the plain versions


@pytest.mark.parametrize("case", SOLVER_CASES, ids=lambda c: c[0])
def test_process_mesh_solver_session_matches_jax(jax_side, world_side, case):
    """``exe.iterate`` on a process mesh: every rank's session equals the
    JAX session (and its own host loop of ``exe(x)`` calls)."""
    case_id, _, _, combine, _ = case
    want = {k.split("|", 1)[1]: v for k, v in jax_side.items()
            if k.startswith(case_id + "|")}
    for res in world_side:
        got = {k.split("|", 1)[1]: v for k, v in res.items()
               if k.startswith(case_id + "|")}
        assert got["scheme_id"] == str(want["scheme_id"])
        assert got["steps"] == int(want["steps"])
        assert got["converged"] == bool(want["converged"])
        if combine == "power-tol":
            np.testing.assert_allclose(got["x"], want["x"], rtol=1e-5,
                                       atol=1e-5)
            continue
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_array_equal(got["host_loop"], want["x"])


@pytest.mark.parametrize("ir_plan", IR_PLANS, ids=lambda p: p[0])
def test_process_mesh_plan_ir_is_the_one_jax_read(jax_side, world_side,
                                                  ir_plan):
    """The IR a process mesh writes is field for field the one the JAX
    runner read and ran; read back on the process mesh, it answers as the
    JAX plan did."""
    name = ir_plan[0]
    for res in world_side:
        assert res[f"{name}|ir"] == json.loads(str(jax_side[f"{name}|port_ir"]))
        assert res[f"{name}|scheme_id"] == str(
            jax_side[f"{name}|port_ir_scheme_id"])
        np.testing.assert_array_equal(res[f"{name}|y"],
                                      jax_side[f"{name}|port_ir_y"])
