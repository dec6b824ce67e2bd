"""The port's SpMV examples (``examples/torch_*.py``) against the JAX package.

Each example runs in process through ``main(["--device", "cpu"])`` and its
own assertions must hold.  Values from host-side code are computed with the
JAX package too and must be equal: the auto plan's tuple and ``describe()``
fields, the partitions' ``padding_efficiency``, the engine's plans, the
topology example's picks and modelled transfers.  Answers are held to the
numpy oracle, as the JAX scripts hold them, and to the JAX package's
``impl="xla"`` single-device plan on the same matrix with rtol = atol =
2e-4 (the reference's tolerance, tests/test_kernels.py:35).  Every example
raises without a card unless it is given ``--device cpu``.  The two LM
examples and the tools are in tests/test_torch_examples_lm.py.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from repro.api import SparseMatrix as JSparseMatrix
from repro.api.plan import resolve_scheme
from repro.core import adaptive as JA
from repro.core import distributed as JD
from repro.core.partition import partition_1d, partition_2d
from repro.topo import CollectiveCostModel, FakeTopology
from repro_torch.core import adaptive as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
EXAMPLES = ("quickstart", "spmv_end_to_end", "engine_quickstart",
            "solver_quickstart", "serve_quickstart", "slo_quickstart",
            "topo_quickstart", "cluster_quickstart", "serve_lm", "train_lm")
CPU = ["--device", "cpu"]


def load(path: str):
    """Import a script of the repo by its path (no package around it)."""
    name = "_ex_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name: str):
    return load(f"examples/torch_{name}.py")


def jax_y(a, x):
    return np.asarray(JSparseMatrix.from_dense(a).plan(impl="xla").compile()(x))


def test_examples_are_the_jax_scripts_counterparts():
    for name in EXAMPLES:
        with open(os.path.join(ROOT, "examples", f"{name}.py")) as fh:
            jax_src = fh.read()
        with open(os.path.join(ROOT, "examples", f"torch_{name}.py")) as fh:
            src = fh.read()
        # every assertion of the JAX script is kept
        assert src.count("assert") >= jax_src.count("assert"), name
        assert "def main(argv=None)" in src and "--device" in src, name
        assert not re.search(r"XLA_FLAGS|lax\.|jax", src), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="CUDA device"):
        example(name).main([])


def test_single_pod_is_the_reference_pod():
    """The port's preset has the reference's 256 chips (the quickstart's
    auto plan at fit=False depends on it)."""
    assert TA.HardwareModel.single_pod().chips == JA.HardwareModel.single_pod().chips
    assert TA.HardwareModel.single_pod() == TA.HardwareModel(chips=256)


def test_quickstart():
    out = example("quickstart").main(CPU)
    assert out["impls"] == ["torch"]
    from repro.data import scale_free_matrix

    a = scale_free_matrix(rows=1024, cols=1024, nnz_target=6 * 1024, seed=0)
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    want = jax_y(a, x)
    for fmt in ("csr", "coo", "bcsr", "bcoo"):
        y = out["y"][fmt, "torch"]
        np.testing.assert_allclose(y, a @ x, **TOL)
        np.testing.assert_allclose(y, want, **TOL)
        assert out["spmv_err"][fmt, "torch"] < 1e-4
    assert out["batch_err"]["torch"] < 1e-4
    jplan = JSparseMatrix.from_dense(a).plan(
        scheme="auto", hw=JA.HardwareModel.single_pod(), fit=False)
    s = jplan.scheme
    assert out["plan"] == (s.partitioning, s.scheme, s.fmt, s.merge, tuple(s.grid))
    got, jdesc = out["describe"].splitlines(), jplan.describe().splitlines()
    head = re.compile(r"ExecutionPlan\[(\S+) fmt=(\S+) merge=(\S+) "
                      r"grid=(\(.*?\)) impl=\S+ dtype=(\S+)")
    assert head.match(got[0]).groups() == head.match(jdesc[0]).groups()
    assert got[1] == jdesc[1]  # the reason
    keys = re.compile(r"(\w+)=")
    assert keys.findall(got[2]) == keys.findall(jdesc[2])  # the estimate's terms


def test_spmv_end_to_end():
    out = example("spmv_end_to_end").main(CPU)
    from repro.data import paper_large_suite

    spec = paper_large_suite(1)[11]
    a = spec.build()
    assert out["matrix"] == spec.name
    stats = JSparseMatrix.from_dense(a).stats
    p1 = resolve_scheme(stats, a.shape, 8, "1d.nnz")
    part1 = partition_1d(a, p1.grid[0], fmt=p1.fmt, balance=p1.scheme, block=(8, 16))
    assert out["1d"]["pad_eff"] == part1.padding_efficiency
    ring, _ = JD.bucket_by_source_shard(part1, 8)
    assert out["ring"]["pad_eff"] == ring.padding_efficiency
    p2 = resolve_scheme(stats, a.shape, 8, "2d.equally-sized", grid=(4, 2))
    part2 = partition_2d(a, tuple(p2.grid), fmt=p2.fmt, scheme=p2.scheme, block=(8, 16))
    assert out["2d"]["grid"] == tuple(p2.grid)
    assert out["2d"]["pad_eff"] == part2.padding_efficiency
    for key in ("1d", "ring", "2d"):
        assert out[key]["err"] < 1e-4, key
    # the power iteration's eigenvalue, against the reference's plan's loop
    sq = min(a.shape)
    a_sq = a[:sq, :sq] + np.eye(sq, dtype=np.float32) * 0.1
    exe = JSparseMatrix.from_dense(a_sq).plan(impl="xla").compile()
    v = np.ones(sq, np.float32) / np.sqrt(sq)
    for _ in range(10):
        y = np.asarray(exe(v))
        v = y / np.linalg.norm(y)
    np.testing.assert_allclose(out["eigenvalue"], float(v @ (a_sq @ v)), **TOL)


def _jax_plans(mats, parts=8):
    """The JAX engine's plan of each matrix on ``parts`` devices (its
    ``register`` resolves "auto" over the pool, as ``resolve_scheme``)."""
    out = {}
    for name, a in mats.items():
        p = resolve_scheme(JSparseMatrix.from_dense(a).stats, a.shape, parts)
        out[name] = (p.partitioning, p.scheme, p.fmt, tuple(p.grid))
    return out


def test_engine_quickstart():
    out = example("engine_quickstart").main(CPU)
    from repro.data import paper_small_suite

    suite = paper_small_suite()
    assert out["plans"] == _jax_plans({s.name: s.build() for s in suite})
    assert out["multiply_err"] < 1e-4 and out["stream_err"] < 1e-4
    assert out["breakdown"]["requests"] == 5 and out["breakdown"]["vectors"] == 33


def test_solver_quickstart():
    out = example("solver_quickstart").main(CPU)
    n = 96
    lap = (4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)
    b = np.random.default_rng(0).integers(-2, 3, n).astype(np.float32)
    res = JSparseMatrix.from_dense(lap).plan(fmt="csr", impl="xla").compile().iterate(
        np.zeros(n, np.float32), tol=1e-5, combine="cg", b=b, max_steps=200,
        check_every=1)
    assert out["cg"]["steps"] == res.steps == 11
    np.testing.assert_allclose(out["cg"]["x"], np.asarray(res.x), **TOL)
    np.testing.assert_allclose(out["cg"]["x"], np.linalg.solve(lap, b), **TOL)
    assert out["served"]["steps"] == 32 and out["served"]["admissions"] == 1


def test_serve_quickstart():
    out = example("serve_quickstart").main(CPU)
    from repro.data.matrices import block_matrix, scale_free_matrix

    mats = {
        "acme:social": np.round(scale_free_matrix(96, 128, 700, seed=0) * 2.0),
        "globex:fem": np.round(
            block_matrix(96, 128, block=(8, 16), block_density=0.2, seed=2) * 2.0),
    }
    assert out["plans"] == _jax_plans(mats)
    assert out["lost"] == 0 and out["completed"] == out["bitexact"] == 108
    assert out["infeasible_rejected"] == 12


def test_slo_quickstart():
    out = example("slo_quickstart").main(CPU)
    assert out["completed"] == out["bitexact"] == 160
    assert out["rt_p99_ms"] < out["batch_p99_ms"] and out["preemptions"] > 0


def test_topo_quickstart():
    out = example("topo_quickstart").main(CPU)
    topo = FakeTopology.pim_like((2, 2))
    model = CollectiveCostModel(topo)
    rng = np.random.default_rng(0)
    for name, shape in (("tall", (512, 128)), ("wide", (128, 512))):
        a = rng.standard_normal(shape).astype(np.float32)
        a[np.abs(a) < 1.2] = 0.0
        x = rng.standard_normal(shape[1]).astype(np.float32)
        got = out["plans"][name]
        np.testing.assert_array_equal(got["x"], x)  # the same draws
        plan = JA.Plan("2d", "equally-sized", "coo", "psum_scatter", (2, 2), "")
        best, price = model.rank(plan, shape, 4, ("rows", "cols"))[0]
        assignment = got["assignment"]
        assert [tuple(g) for g in assignment["physical"]] == list(best.physical)
        assert tuple(assignment["logical"]) == best.logical
        for key in ("load_s", "merge_s"):
            assert assignment["transfer"][key] == pytest.approx(price[key], rel=1e-12)
        np.testing.assert_allclose(got["y"], a @ x, **TOL)
        np.testing.assert_allclose(got["y"], jax_y(a, x), **TOL)
    assert out["plans"]["tall"]["slots"] != out["plans"]["wide"]["slots"]


def test_cluster_quickstart():
    out = example("cluster_quickstart").main(CPU)
    assert out["social"]["placements"] == ["w0", "w1"]
    assert out["mesh"]["from_cache"] and out["mesh"]["measurements"] == 0
    assert out["served"][out["victim"]] == "lost"
    assert out["routed"] == 17
