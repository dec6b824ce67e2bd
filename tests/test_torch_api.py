"""The whole single-device slice: repro_torch.api against repro.api.

Same numpy inputs through ``SparseMatrix -> plan -> compile -> exe`` in both
packages: the auto scheme resolves to the same ``scheme_id``, results of
``impl="cuda"`` (on the CPU: the kernels' plain versions) equal JAX
``impl="pallas"`` (interpret mode) exactly on integer-valued inputs, and the
plan IR is read across both packages.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.api import SparseMatrix as JSparseMatrix
from repro.api import plan_from_ir as j_plan_from_ir
from repro.data.matrices import block_matrix, regular_matrix, scale_free_matrix
from repro_torch.api import AXES_2D, SparseMatrix, executor, plan_from_ir
from repro_torch.core import formats as TF
from repro_torch.core.mesh import make_mesh
from repro_torch.topo import AxisAssignment, FakeTopology

from _torch_common import BF16, rand_sparse
from _torch_mesh_cases import BLOCK as MESH_BLOCK
from _torch_mesh_cases import cases as mesh_cases
from _torch_mesh_cases import matrix as mesh_matrix
from _torch_mesh_cases import vectors as mesh_vectors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORMATS = ["coo", "csr", "bcoo", "bcsr"]


def _ints(a):
    """Round a generator's float matrix to nonzero integers in {±1, ±2}."""
    return (np.sign(a) * np.minimum(np.ceil(np.abs(a)), 2)).astype(np.float32)


@pytest.mark.parametrize("kind,want", [
    ("regular", "2d.equally-sized.coo.psum_scatter"),
    ("scale-free", "1d.nnz.coo.ppermute"),
    ("block", "2d.equally-sized.bcoo.psum_scatter"),
])
def test_auto_scheme_matches_jax(kind, want):
    a = {"regular": lambda: regular_matrix(96, 128, 5, seed=1),
         "scale-free": lambda: scale_free_matrix(256, 256, 6000, seed=2),
         "block": lambda: block_matrix(96, 128, block=(8, 16), seed=3)}[kind]()
    jp = JSparseMatrix.from_dense(a).plan(scheme="auto")
    tp = SparseMatrix.from_dense(a).plan(scheme="auto", device="cpu")
    assert tp.scheme_id == jp.scheme_id == want
    assert tp.scheme.reason == jp.scheme.reason and tp.grid == jp.grid
    ri, ci = np.nonzero(a)
    parts = SparseMatrix.from_parts(ri, ci, a[ri, ci], a.shape)
    assert parts.plan(device="cpu").scheme_id == want
    assert parts._dense is None  # triplets are never densified


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int8],
                         ids=lambda d: np.dtype(d).name)
def test_pipeline_matches_jax_pallas(fmt, dtype):
    a = _ints(block_matrix(96, 128, block=(8, 16), block_density=0.3, seed=3))
    a[16:24] = 0  # an empty block-row
    a = a.astype(dtype)
    rng = np.random.default_rng(0)
    jexe = JSparseMatrix.from_dense(a).plan(fmt=fmt, impl="pallas").compile()
    texe = SparseMatrix.from_dense(a).plan(fmt=fmt, device="cpu").compile()
    assert texe.impl == "cuda" and texe.device.type == "cpu"
    for batch in (None, 3, 8):
        shape = (128,) if batch is None else (128, batch)
        x = rng.integers(-2, 3, shape).astype(dtype)
        want = np.asarray(jexe(x) if batch is None else jexe.batch(x))
        got = texe(x) if batch is None else texe.batch(x)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_torch_impl_matches_jax_xla(fmt):
    a = rand_sparse(64, 96, 0.1, np.float32, seed=41, integer=True)
    X = np.random.default_rng(42).integers(-2, 3, (96, 3)).astype(np.float32)
    want = JSparseMatrix.from_dense(a).plan(fmt=fmt).compile().batch(X)
    exe = SparseMatrix.from_dense(a).plan(fmt=fmt, impl="torch",
                                          device="cpu").compile()
    np.testing.assert_array_equal(exe.batch(X), want)
    np.testing.assert_array_equal(exe(X[:, 0]), want[:, 0])


def test_bf16_results_come_back_widened_to_f32(monkeypatch):
    """The rule per impl: impl="cuda" returns float32 (the kernels'
    accumulation dtype, as JAX impl="pallas"); impl="torch" returns
    ml_dtypes bfloat16 where ml_dtypes imports (as JAX impl="xla") and is
    widened to float32, exactly, where it does not (the card's machine)."""
    a = rand_sparse(32, 48, 0.2, np.float32, seed=43, integer=True).astype(BF16)
    x = np.ones(48, BF16)
    want = a.astype(np.float32).sum(1)

    def run(impl):
        return SparseMatrix.from_dense(a).plan(impl=impl, device="cpu").compile()(x)

    y = run("cuda")
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, want)
    y = run("torch")
    assert y.dtype == BF16
    np.testing.assert_array_equal(y.astype(np.float32), want)
    monkeypatch.setattr(executor, "_np_bfloat16", lambda: None)  # no ml_dtypes
    y = run("torch")
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, want)


MESH_BF16_CASES = ["1d-rows-coo-torch-bf16", "2d-es-scatter-bcoo-torch-bf16"]


@pytest.fixture(scope="module")
def jax_mesh_bf16(tmp_path_factory):
    """The JAX MeshExecutor's answers for MESH_BF16_CASES on 4 fake devices
    (tests/_torch_mesh_runner.py, which owns its process)."""
    out = tmp_path_factory.mktemp("bf16") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([
        os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_runner.py"),
         str(out), *MESH_BF16_CASES], capture_output=True, text=True, env=env,
        timeout=600)
    if proc.returncode != 0:
        pytest.fail(f"mesh runner crashed:\n{proc.stderr[-3000:]}")
    if "MESH SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z)


def _bits(y: np.ndarray) -> np.ndarray:
    assert y.dtype == BF16, y.dtype
    return y.view(np.uint16)


def test_bf16_torch_impl_matches_jax_xla_dtype_and_bits(jax_mesh_bf16):
    """impl="torch" hands back what JAX impl="xla" does for a bfloat16
    matrix — the dtype and every bit — on one device and on 4 parts."""
    a = _ints(block_matrix(96, 128, block=(8, 16), block_density=0.3, seed=3))
    a[5, :] = 2.0  # a row the element-granular 1D split cuts
    a = a.astype(BF16)
    X = np.random.default_rng(5).integers(-2, 3, (128, 3)).astype(BF16)
    for fmt in FORMATS:
        want = np.asarray(JSparseMatrix.from_dense(a).plan(fmt=fmt).compile()
                          .batch(X))
        got = SparseMatrix.from_dense(a).plan(fmt=fmt, impl="torch",
                                              device="cpu").compile().batch(X)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fmt)
    for case_id in MESH_BF16_CASES:
        plan = next(c[1] for c in mesh_cases() if c[0] == case_id)
        _, scheme, fmt, merge, grid, _ = plan
        ma, mx, mX = (t.astype(BF16) for t in (mesh_matrix("bf16"),
                                                *mesh_vectors("bf16")))
        exe = SparseMatrix.from_dense(ma).plan(
            scheme=scheme, fmt=fmt, merge=merge, grid=grid, impl="torch",
            devices=["cpu"] * 4, block=MESH_BLOCK).compile()
        for got, key in ((exe(mx), "y"), (exe.batch(mX), "Y")):
            assert got.dtype.name == str(jax_mesh_bf16[f"{case_id}|{key}_dtype"])
            wide = jax_mesh_bf16[f"{case_id}|{key}"]  # stored widened, exactly
            np.testing.assert_array_equal(_bits(got),
                                          _bits(wide.astype(BF16)), err_msg=key)


def test_x_may_be_a_tensor_and_is_checked():
    a = rand_sparse(32, 48, 0.2, np.int8, seed=44)
    exe = SparseMatrix.from_dense(a).plan(device="cpu").compile()
    x = torch.arange(48, dtype=torch.int8) % 3
    np.testing.assert_array_equal(exe(x), a.astype(np.int32) @ x.numpy())
    with pytest.raises(TypeError, match="cast"):
        exe(np.ones(48, np.float32))  # float x into an int8 matrix
    with pytest.raises(ValueError, match="48 cols"):
        exe(np.ones(40, np.int8))
    with pytest.raises(ValueError, match="cols, B"):
        exe.batch(np.ones(48, np.int8))
    exe.release()
    with pytest.raises(RuntimeError, match="released"):
        exe(x)


def test_constructors_agree_on_fingerprint_with_jax():
    a = rand_sparse(96, 128, 0.1, np.float32, seed=45)
    ri, ci = np.nonzero(a)
    want = JSparseMatrix.from_dense(a).fingerprint()
    sms = {
        "dense": SparseMatrix.from_dense(a),
        "parts": SparseMatrix.from_parts(ri, ci, a[ri, ci], a.shape),
        "format": SparseMatrix.from_format(TF.dense_to_coo(a)),
        "bcsr": SparseMatrix.from_format(TF.dense_to_bcsr(a, (8, 16))),
        "scipy": SparseMatrix.from_scipy(sp.csr_matrix(a)),
    }
    x = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    for name, sm in sms.items():
        assert sm.fingerprint() == want, name
        assert sm.stats.nnz == len(ri), name
        np.testing.assert_allclose(sm.plan(device="cpu").compile()(x), a @ x,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    b = a.astype(BF16)
    assert SparseMatrix.from_dense(b).fingerprint() == \
        JSparseMatrix.from_dense(b).fingerprint()


def test_container_from_triplets_matches_the_dense_build():
    a = rand_sparse(64, 96, 0.1, np.float32, seed=46)
    ri, ci = np.nonzero(a)
    parts = SparseMatrix.from_parts(ri, ci, a[ri, ci], a.shape)
    dense = SparseMatrix.from_dense(a)
    for fmt in FORMATS:
        for dtype in (None, "bfloat16", torch.int8):
            got, want = parts.container(fmt, dtype=dtype), dense.container(
                fmt, dtype=dtype)
            for f in got._tensors:
                assert torch.equal(getattr(got, f), getattr(want, f)), (fmt, f)
    assert parts._dense is None


@pytest.mark.parametrize("fmt", FORMATS)
def test_plan_ir_is_read_across_both_packages(fmt):
    a = _ints(block_matrix(48, 64, block=(8, 16), block_density=0.3, seed=3))
    x = np.random.default_rng(0).integers(-2, 3, 64).astype(np.float32)
    jsm, tsm = JSparseMatrix.from_dense(a), SparseMatrix.from_dense(a)
    # port -> JAX
    tp = tsm.plan(fmt=fmt, device="cpu")
    ir = json.loads(json.dumps(tp.to_ir()))
    assert ir["impl"] == "pallas"  # the wire keeps the JAX impl names
    jp = j_plan_from_ir(ir, jsm)
    assert jp.scheme_id == tp.scheme_id and jp.impl == "pallas"
    np.testing.assert_array_equal(np.asarray(jp.compile()(x)), tp.compile()(x))
    # JAX -> port
    jp = jsm.plan(fmt=fmt, impl="xla")
    jp.measured = {"mean_s": 1.5e-3, "candidates": 3}
    tp2 = plan_from_ir(json.loads(json.dumps(jp.to_ir())), tsm, device="cpu")
    assert tp2.scheme_id == jp.scheme_id and tp2.impl == "torch"
    assert tp2.estimate == jp.estimate and tp2.measured == jp.measured
    assert "measured: 1.50e-03s/call over 3 candidates" in tp2.describe()
    np.testing.assert_array_equal(tp2.compile()(x), np.asarray(jp.compile()(x)))
    assert tp2.to_ir()["impl"] == "xla"


def test_plan_ir_errors():
    tsm = SparseMatrix.from_dense(rand_sparse(16, 16, 0.3, np.float32, seed=1))
    ir = tsm.plan(device="cpu").to_ir()
    with pytest.raises(ValueError, match="version"):
        plan_from_ir({**ir, "ir_version": 99}, tsm, device="cpu")
    with pytest.raises(ValueError, match="malformed"):
        plan_from_ir({"ir_version": 2}, tsm, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        plan_from_ir({**ir, "impl": "triton"}, tsm, device="cpu")
    # a mesh record lays every part on the one device it is given
    mesh_ir = {**ir, "scheme": {**ir["scheme"], "partitioning": "1d",
                                "scheme": "nnz", "merge": "ppermute",
                                "grid": [4, 1]},
               "mesh": {"shape": [4], "axes": ["parts"]}}
    pln = plan_from_ir(mesh_ir, tsm, device="cpu")
    assert pln.is_distributed and pln.mesh.devices.shape == (4,)
    assert pln.device.type == "cpu" and pln.scheme_id == "1d.nnz.coo.ppermute"
    x = np.arange(16, dtype=np.float32)
    np.testing.assert_allclose(pln.compile()(x), tsm.dense().numpy() @ x,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="4 devices"):
        plan_from_ir(mesh_ir, tsm, devices=["cpu"] * 3)
    # distinct cards wait for multi-card meshes
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan_from_ir(mesh_ir, tsm, devices=["cuda:0", "cuda:1"] * 2)


def test_plan_errors_and_unported_options():
    """Unported options raise; mesh= / devices= plan P parts on one device;
    topology= places them, and its wrong inputs raise as the reference's."""
    sm = SparseMatrix.from_dense(rand_sparse(16, 16, 0.3, np.float32, seed=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sm.plan()  # device="cuda" is the default: no fallback to the CPU
    with pytest.raises(ValueError, match="unknown impl"):
        sm.plan(impl="pallas", device="cpu")
    for kw in ({"devices": ["cuda:0", "cuda:1"]},
               {"devices": ["cpu", "cuda:0"]}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sm.plan(device="cpu", **kw)
    # topology=: its devices are the pool (ported: repro_torch.topo)
    placed = sm.plan(scheme="2d.equally-sized",
                     topology=FakeTopology.pim_like((2, 2), devices=["cpu"] * 4))
    assert placed.grid == (2, 2) and placed.mesh.slots.size == 4
    assert placed.scheme_id.startswith("2d.equally-sized.coo.psum_scatter@rows=")
    with pytest.raises(ValueError, match="abstract"):
        sm.plan(device="cpu", topology=FakeTopology.pim_like((2, 2)))
    with pytest.raises(ValueError, match="requires topology"):
        sm.plan(device="cpu", assignment=AxisAssignment(("parts",), (("flat",),)))
    tuned = sm.plan(scheme="tune", device="cpu")  # ported: repro_torch.tune
    assert tuned.measured["candidates"] >= 1 and tuned.impl == "cuda"
    with pytest.raises(ValueError, match="searches"):
        sm.plan(scheme="tune", fmt="csr", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sm.plan(devices=["cuda"] * 4)  # the card, and no fallback
    # P parts on one device: by devices= or by a mesh of that device
    mesh = make_mesh((2, 2), AXES_2D, ["cpu"] * 4)
    by_mesh = sm.plan(scheme="2d.equally-sized", mesh=mesh)
    by_pool = sm.plan(scheme="2d.equally-sized", devices=["cpu"] * 4)
    for pln in (by_mesh, by_pool):
        assert pln.is_distributed and pln.grid == (2, 2)
        assert pln.mesh.axis_names == AXES_2D and pln.device.type == "cpu"
        assert "mesh(2, 2)(cpu)" in pln.describe()
    with pytest.raises(ValueError, match="not both"):
        sm.plan(mesh=mesh, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not match"):
        sm.plan(scheme="1d", mesh=mesh)
    pln = sm.plan(scheme="2d.equally-sized", device="cpu")
    assert pln.scheme_id == "2d.equally-sized.coo.psum_scatter"
    assert pln.grid == (1, 1) and not pln.is_distributed
    text = pln.describe()
    assert "equally-sized" in text and "single-device(cpu)" in text
    assert set(pln.estimate) == {"load_s", "kernel_s", "merge_s"}
