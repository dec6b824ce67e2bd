"""repro_torch.tune and repro_torch.data against the JAX package.

The same seeded numpy inputs go through both packages:

* ``data.matrices``: every generator and both suites, array for array.
* ``CandidateGenerator.plans``: the same scheme ids, grids and formats in
  the same order, impl names mapped ``torch``<->``xla`` and
  ``cuda``<->``pallas`` — on one device here, on four parts against the
  JAX package on 4 fake devices in a subprocess
  (tests/_torch_engine_runner.py ``--tune``, once per module).
* ``Measurer.measure`` under a clock that reads k**2 at its k-th call: the
  same Measurement (so the same calls in the same order), single-device
  and 4 parts; ``FakeMeasurer``'s hash; ``TuningCache`` and ``make_key``.
* Each Tuner, ``scheme="tune"`` and engine test of tests/test_tune.py and
  each drift test of tests/test_serve.py as a scenario run on both
  packages, the JAX engine on one device next to the port's
  ``SpmvEngine(devices=["cpu"], impl="torch")``.  The port's FakeMeasurer
  hashes each candidate under its JAX impl name, so both draw the same
  pseudo-times.  Outcomes — winners, incumbents, ``swapped``, triggers,
  event counts and the answers after a swap — must be equal, answers bit
  for bit (integer-valued inputs).

Then the port's own: ``topology=`` at every layer, the snapshot of ``last_x``, a
request or a solver session racing a swap (and a kernel error racing one,
which is not rerun), a ``cuda`` candidate on a CUDA device that raises
(reported, not dropped), a real Measurer on the CPU, and a time-bounded
stress test of refinements swapping plans under many multiplying threads.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

import repro.data.matrices as jmat
import repro.tune as jtune
import repro_torch.data.matrices as tmat
import repro_torch.tune as ttune
from repro.api import SparseMatrix as JSparseMatrix
from repro.engine import SpmvEngine as JEngine
from repro_torch.api import SparseMatrix
from repro_torch.engine import SpmvEngine
from repro_torch.topo import FakeTopology

from _torch_common import BF16
from _torch_engine_cases import (PARTS, TUNE_CASES, TUNE_MEASURE, TUNE_SEED,
                                 case_key, matrices, quadratic_clock, vectors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TO_JAX = {"torch": "xla", "cuda": "pallas"}
CPU = ["cpu"]
KINDS = ("regular", "scale-free", "block")
TIMEOUT = 60  # seconds any thread is waited for


def _ints(a):
    return np.round(a * 2.0).astype(np.float32)


def _matrix(kind="regular"):
    """tests/test_tune.py's matrices, integer-valued (exact answers)."""
    if kind == "regular":
        return _ints(jmat.regular_matrix(96, 128, 5, seed=1))
    if kind == "scale-free":
        return _ints(jmat.scale_free_matrix(96, 128, 600, seed=2))
    return _ints(jmat.block_matrix(96, 128, block=(8, 16), block_density=0.2,
                                   seed=3))


def _x(n, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (n, batch)
    return rng.integers(-3, 4, shape).astype(np.float32)


def _jaxify(obj):
    """A port outcome with impl names as the JAX package spells them."""
    if isinstance(obj, str):
        head, sep, tail = obj.rpartition("|")
        if sep and tail in TO_JAX:
            return f"{head}|{TO_JAX[tail]}"
        return TO_JAX.get(obj, obj)
    if isinstance(obj, dict):
        return {k: _jaxify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_jaxify(v) for v in obj)
    return obj


def _assert_same(got, want, path="outcome"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


# ----------------------------------------------------------- data.matrices

GENERATORS = {
    "regular": lambda m, dt: m.regular_matrix(96, 128, 5, seed=1, dtype=dt),
    "regular-wide": lambda m, dt: m.regular_matrix(64, 512, 9, seed=4, dtype=dt),
    "scale-free": lambda m, dt: m.scale_free_matrix(96, 128, 600, seed=2,
                                                    dtype=dt),
    "scale-free-alpha": lambda m, dt: m.scale_free_matrix(
        128, 96, 900, seed=5, alpha=1.2, dtype=dt),
    "block": lambda m, dt: m.block_matrix(96, 128, block=(8, 16),
                                          block_density=0.2, seed=3, dtype=dt),
    "block-4x8": lambda m, dt: m.block_matrix(64, 64, block=(4, 8),
                                              block_density=0.5, seed=6,
                                              dtype=dt),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_jax(name, dtype):
    got, want = GENERATORS[name](tmat, dtype), GENERATORS[name](jmat, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SUITES = [("small", i) for i in range(4)] + [("large", i) for i in range(22)]


@pytest.mark.parametrize("suite,i", SUITES, ids=lambda v: str(v))
def test_suite_matrices_match_jax(suite, i):
    got = getattr(tmat, f"paper_{suite}_suite")()[i]
    want = getattr(jmat, f"paper_{suite}_suite")()[i]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.build(), want.build())


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_suite_specs_match_jax(scale):
    for suite in ("small", "large"):
        got = getattr(tmat, f"paper_{suite}_suite")(scale)
        want = getattr(jmat, f"paper_{suite}_suite")(scale)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
    with pytest.raises(ValueError):
        tmat.MatrixSpec("x", "banded", 8, 8).build()


# ----------------------------------------------------------- candidates

def _cands(plans) -> list:
    return [[p.scheme_id, TO_JAX.get(p.impl, p.impl), list(p.grid), p.fmt]
            for p in plans]


IMPL_SETS = [("torch",), ("cuda",), ("torch", "cuda"), ("cuda", "torch")]


@pytest.mark.parametrize("cap", [16, 3])
@pytest.mark.parametrize("exotic", [False, True])
@pytest.mark.parametrize("impls", IMPL_SETS, ids="+".join)
@pytest.mark.parametrize("kind", KINDS)
def test_candidates_match_jax_one_device(kind, impls, exotic, cap):
    a = _matrix(kind)
    gen = ttune.CandidateGenerator(impls=impls, include_exotic=exotic,
                                   max_candidates=cap)
    jgen = jtune.CandidateGenerator(impls=tuple(TO_JAX[i] for i in impls),
                                    include_exotic=exotic, max_candidates=cap)
    got = gen.plans(SparseMatrix.from_dense(a), device="cpu")
    want = _cands(jgen.plans(JSparseMatrix.from_dense(a)))
    assert _cands(got) == want
    assert all(not p.is_distributed and p.device.type == "cpu" for p in got)


def test_candidate_generator_defaults():
    """The port searches its kernels by default, as plan() defaults to them."""
    gen = ttune.CandidateGenerator()
    assert gen.impls == ("cuda",)
    assert (gen.include_exotic, gen.max_candidates) == (False, 8)
    sm = SparseMatrix.from_dense(_matrix("block"))
    plans = gen.plans(sm, device="cpu")
    assert {p.impl for p in plans} == {"cuda"}
    assert {"bcoo", "bcsr"} & {p.fmt for p in plans}


@pytest.fixture(scope="module")
def jax_four_parts(tmp_path_factory):
    out = tmp_path_factory.mktemp("tune") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_engine_runner.py"),
         str(out), "--tune"], capture_output=True, text=True, env=env,
        timeout=300)
    if proc.returncode != 0:
        pytest.fail(f"engine runner crashed:\n{proc.stderr[-3000:]}")
    if "ENGINE SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return {k: json.loads(str(v)) for k, v in z.items()}


@pytest.mark.parametrize("case", TUNE_CASES, ids=case_key)
def test_candidates_match_jax_four_parts(jax_four_parts, case):
    matrix, exotic, cap = case
    gen = ttune.CandidateGenerator(impls=("torch", "cuda"), include_exotic=exotic,
                                   max_candidates=cap)
    plans = gen.plans(SparseMatrix.from_dense(matrices()[matrix]),
                      devices=CPU * PARTS)
    assert _cands(plans) == jax_four_parts[f"cands|{case_key(case)}"]
    assert all(p.is_distributed for p in plans)


# ----------------------------------------------------------- measurement

def _measurement(m) -> list:
    return [m.scheme_id, TO_JAX.get(m.impl, m.impl), list(m.grid), m.fmt,
            m.mean_s, list(m.times_s), m.compile_s, m.phases]


@pytest.mark.parametrize("knobs", [dict(), dict(warmup=0, iters=1, trim=0),
                                   dict(warmup=3, iters=2, trim=1),
                                   dict(warmup=1, iters=7, trim=2)], ids=str)
@pytest.mark.parametrize("scheme,batch", [("1d.nnz", None), ("2d.equally-sized", 3)])
def test_measurement_matches_jax_single_device(scheme, batch, knobs):
    a, x = _matrix(), _x(128, batch)
    plan = SparseMatrix.from_dense(a).plan(scheme=scheme, device="cpu",
                                          impl="torch")
    jplan = JSparseMatrix.from_dense(a).plan(scheme=scheme)
    got = ttune.Measurer(clock=quadratic_clock(), **knobs).measure(plan, x)
    want = jtune.Measurer(clock=quadratic_clock(), **knobs).measure(jplan, x)
    assert _measurement(got) == _measurement(want)


@pytest.mark.parametrize("case", TUNE_MEASURE, ids=case_key)
def test_measurement_matches_jax_four_parts(jax_four_parts, case):
    matrix, scheme, batch = case
    plan = SparseMatrix.from_dense(matrices()[matrix]).plan(
        scheme=scheme, devices=CPU * PARTS, impl="torch")
    vecs = vectors()
    x = vecs["x"] if batch is None else vecs["X"][:, :batch]
    got = ttune.Measurer(clock=quadratic_clock()).measure(plan, x)
    assert set(got.phases) == {"load", "kernel", "retrieve"}
    assert _measurement(got) == jax_four_parts[f"measure|{case_key(case)}"]


@pytest.mark.parametrize("matrix", KINDS)
def test_fake_tuner_matches_jax_four_parts(jax_four_parts, matrix):
    r = ttune.Tuner(generator=ttune.CandidateGenerator(impls=("torch",)),
                    measurer=PortFake(seed=TUNE_SEED)).tune(
        SparseMatrix.from_dense(matrices()[matrix]), devices=CPU * PARTS)
    got = [r.best.scheme_id, list(r.best.grid), r.baseline.scheme_id,
           r.speedup, [m.scheme_id for m in r.measurements]]
    assert got == jax_four_parts[f"tuner|{matrix}"]


@pytest.mark.parametrize("batch", [None, 1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_representative_matches_jax(dtype, batch):
    a = _matrix()
    jdt = BF16 if dtype == "bfloat16" else np.dtype(dtype)
    got = ttune.Measurer(seed=4).representative(
        SparseMatrix.from_dense(a, dtype=dtype), batch=batch)
    want = jtune.Measurer(seed=4).representative(
        JSparseMatrix.from_dense(a.astype(jdt)), batch=batch)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                  np.asarray(want).view(np.uint8))


def test_representative_bf16_without_ml_dtypes(monkeypatch):
    """Where ml_dtypes does not import (the card's machine) a bf16 matrix
    gets a bf16 tensor of the same values."""
    import repro_torch.tune.measure as measure

    a = _matrix()
    want = ttune.Measurer(seed=4).representative(
        SparseMatrix.from_dense(a, dtype="bfloat16"))
    monkeypatch.setattr(measure, "_np_bfloat16", lambda: None)
    got = ttune.Measurer(seed=4).representative(
        SparseMatrix.from_dense(a, dtype="bfloat16"))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("sid,impl,grid", [
    ("1d.nnz.coo.ppermute", "xla", (1, 1)),
    ("2d.equally-sized.bcoo.psum_scatter", "pallas", (2, 2)),
    ("1d.rows.csr.ppermute", "cuda", (16, 1)),
    ("2d.variable-sized.coo.global", "torch", (4, 4)),
])
def test_fake_measurer_matches_jax(sid, impl, grid, seed):
    plan = types.SimpleNamespace(scheme_id=sid, impl=impl, grid=grid,
                                 fmt=sid.split(".")[2])
    for costs in (None, {sid: 42.0}, {f"{sid}|{impl}": 7.0, sid: 42.0},
                  {"other": 1.0}):
        got = ttune.FakeMeasurer(costs=costs, seed=seed)
        want = jtune.FakeMeasurer(costs=costs, seed=seed)
        assert dataclasses.astuple(got.measure(plan)) == \
            dataclasses.astuple(want.measure(plan))
        assert got.calls == want.calls == [f"{sid}|{impl}"]


def test_real_measurer_single_device_runs_and_releases():
    """tests/test_tune.py's real-Measurer case, on device="cpu"."""
    sm = SparseMatrix.from_dense(_matrix())
    plan = sm.plan(scheme="1d.nnz", device="cpu")
    made = []
    compile_ = plan.compile
    plan.compile = lambda: made.append(compile_()) or made[-1]
    meas = ttune.Measurer(warmup=1, iters=2, trim=0)
    m = meas.measure(plan, meas.representative(sm))
    assert m.mean_s > 0 and len(m.times_s) == 2 and m.compile_s > 0
    assert m.scheme_id == plan.scheme_id and m.impl == "cuda" and not m.phases
    assert made[0].program is None and made[0].container is None  # released


def test_real_measurer_four_parts_splits_phases():
    sm = SparseMatrix.from_dense(_matrix("block"))
    plan = sm.plan(scheme="2d.equally-sized", fmt="bcoo", devices=CPU * PARTS)
    m = ttune.Measurer(warmup=1, iters=3, trim=1).measure(plan, _x(128, 8))
    assert set(m.phases) == {"load", "kernel", "retrieve"}
    assert all(v > 0 for v in m.phases.values())
    assert m.mean_s > 0 and len(m.times_s) == 3


# ----------------------------------------------------------- TuningCache

def _cache_case(mod, path, case) -> dict:
    """One cache behaviour of tests/test_tune.py, on either package."""
    key = mod.TuneKey("fp0", "cpu:1", "float32", 1, "torch")
    if case == "roundtrip":
        cache = mod.TuningCache(path=path)
        record = {"scheme": {"partitioning": "1d"}, "impl": "torch",
                  "mean_s": 1.0}
        cache.put(key, record)
        reloaded = mod.TuningCache(path=path)
        return {"got": reloaded.get(key), "len": len(reloaded),
                "hits": reloaded.hits, "misses": reloaded.misses}
    if case == "isolation":
        cache = mod.TuningCache(path=path)
        cache.put(key, {"mean_s": 1.0})
        others = [mod.TuneKey("fp1", "cpu:1", "float32", 1, "torch"),
                  mod.TuneKey("fp0", "cuda:1", "float32", 1, "torch"),
                  mod.TuneKey("fp0", "cpu:1", "bfloat16", 1, "torch"),
                  mod.TuneKey("fp0", "cpu:1", "float32", 32, "torch"),
                  mod.TuneKey("fp0", "cpu:1", "float32", 1, "cuda"),
                  mod.TuneKey("fp0", "cpu:1", "float32", 1, "torch", (16, 16))]
        return {"others": [cache.get(k) for k in others],
                "base": cache.get(key), "in": key in cache,
                "hits": cache.hits, "misses": cache.misses}
    path.write_text(case)  # a corrupt file
    cache = mod.TuningCache(path=path)
    out = {"len": len(cache), "load_error": cache.load_error}
    cache.put(key, {"mean_s": 2.0})
    out["after"] = mod.TuningCache(path=path).get(key)
    out["version"] = json.loads(path.read_text())["version"]
    return out


CACHE_CASES = ["roundtrip", "isolation", "not json at all {",
               '{"version": 999, "entries": {}}', '{"no_entries_key": true}',
               '{"version": 1, "entries": []}']


@pytest.mark.parametrize("case", CACHE_CASES)
def test_tuning_cache_matches_jax(tmp_path, case):
    got = _cache_case(ttune, tmp_path / "port.json", case)
    want = _cache_case(jtune, tmp_path / "jax.json", case)
    assert got == want
    if case not in ("roundtrip", "isolation"):
        assert got["len"] == 0 and got["load_error"] is not None
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


def test_tuning_cache_reads_a_file_the_jax_package_wrote(tmp_path):
    path = tmp_path / "w.json"
    a = _matrix()
    jtune.Tuner(measurer=jtune.FakeMeasurer(seed=1),
                cache=jtune.TuningCache(path=path)).tune(JSparseMatrix.from_dense(a))
    jcache = jtune.TuningCache(path=path)
    cache = ttune.TuningCache(path=path)
    assert cache.load_error is None and len(cache) == len(jcache) == 1
    assert cache.export() == jcache.export()
    [(encoded, record)] = cache.export().items()
    fp, topo, dtype, batch, impls, block = encoded.split("|")
    key = ttune.TuneKey(fp, topo, dtype, int(batch), impls,
                        tuple(int(b) for b in block.split("x")))
    assert key.encode() == encoded and cache.get(key) == record
    plan = ttune.record_to_plan(record)
    assert plan.tag in {c["scheme_id"] for c in record["candidates"]}
    # the fingerprint is the reference's: the port's own key finds it
    sm = SparseMatrix.from_dense(a)
    own = ttune.make_key(sm, device="cpu", impls="xla")
    assert own == key


def _merge_case(mod, path) -> dict:
    k1 = mod.TuneKey("fp1", "cpu:1", "float32", 1, "torch")
    k2 = mod.TuneKey("fp2", "cpu:1", "float32", 1, "torch")
    w1, w2 = mod.TuningCache(path=path), mod.TuningCache(path=path)
    w1.put(k1, {"mean_s": 1.0})
    w2.put(k2, {"mean_s": 2.0})  # merges w1's key on write
    w1.refresh()  # pulls w2's key without a write of its own
    w1.put(k1, {"mean_s": 3.0})  # last writer wins on k1; k2 survives
    return {"disk": json.loads(path.read_text()), "w1": w1.export(),
            "w2_stale": w2.export(), "fresh": mod.TuningCache(path=path).export()}


def test_tuning_cache_merges_on_write_as_jax(tmp_path):
    got = _merge_case(ttune, tmp_path / "port.json")
    want = _merge_case(jtune, tmp_path / "jax.json")
    assert got == want
    assert len(got["fresh"]) == 2 and len(got["w2_stale"]) == 2


def _counters_case(mod, path) -> dict:
    src = mod.TuningCache(path=None)
    key = mod.TuneKey("fp0", "cpu:1", "float32", 1, "torch")
    src.put(key, {"mean_s": 1.0})
    wire = src.export(key)
    dst = mod.TuningCache(path=path)
    out = {"miss": dst.get(key), "n": dst.ingest(wire), "hit": dst.get(key),
           "contains": key in dst, "hits": dst.hits, "misses": dst.misses,
           "export_one": dst.export(key), "export_all": dst.export(),
           "export_absent": dst.export(mod.TuneKey("x", "cpu:1", "float32", 1,
                                                   "torch")),
           "on_disk": os.path.exists(path)}
    dst.ingest(wire, persist=True)
    out["persisted"] = mod.TuningCache(path=path).export()
    out["ingest_empty"] = dst.ingest({}, persist=True)
    dst.clear()
    out["cleared"] = (len(dst), mod.TuningCache(path=path).export())
    return out


def test_tuning_cache_counters_ingest_export_as_jax(tmp_path):
    got = _counters_case(ttune, tmp_path / "port.json")
    want = _counters_case(jtune, tmp_path / "jax.json")
    assert got == want
    assert got["hits"] == 2 and got["misses"] == 1 and got["n"] == 1


def test_tuning_cache_expands_user_path(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    cache = ttune.TuningCache(path="~/tune-cache/w.json")
    key = ttune.TuneKey("fp0", "cpu:1", "float32", 1)
    cache.put(key, {"mean_s": 1.0})
    assert (tmp_path / "tune-cache" / "w.json").exists()
    assert ttune.TuningCache(path="~/tune-cache/w.json").get(key) == {"mean_s": 1.0}
    assert jtune.TuningCache(path="~/tune-cache/w.json").get(
        jtune.TuneKey("fp0", "cpu:1", "float32", 1, "cuda")) == {"mean_s": 1.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_key_folds_in_dtype_batch_impls_block(dtype):
    a = _matrix()
    jdt = BF16 if dtype == "bfloat16" else np.float32
    sm = SparseMatrix.from_dense(a, dtype=dtype)
    jsm = JSparseMatrix.from_dense(a.astype(jdt))
    cases = [(dict(), ("cuda",), "cuda"), (dict(batch=8), ("cuda",), "cuda"),
             (dict(impls=("cuda", "torch")), ("cuda", "torch"), "cuda+torch"),
             (dict(impls="torch", block=(4, 8)), ("torch",), "torch"),
             (dict(batch=1, block=(16, 16)), ("cuda",), "cuda")]
    for kw, impls, joined in cases:
        got = ttune.make_key(sm, device="cpu", **kw)
        want = jtune.make_key(jsm, **dict(kw, impls=[TO_JAX[i] for i in impls]))
        assert (got.fingerprint, got.topology, got.dtype, got.batch, got.block) \
            == (want.fingerprint, want.topology, want.dtype, want.batch, want.block)
        assert got.impls == joined
    assert ttune.make_key(sm, device="cpu") != ttune.make_key(sm, device="cpu",
                                                             batch=8)
    assert ttune.make_key(sm).topology == "cuda:1"  # the card is the default
    assert ttune.make_key(sm, devices=["cuda"] * 16).topology == "cuda:16"
    assert ttune.make_key(sm, devices=CPU * 4).topology == "cpu:4"
    assert ttune.make_key(sm, device="cpu").dtype == dtype


def test_topology_raises_naming_repro_topo():
    """topology= is taken at every layer that takes it in the reference
    (ported: repro_torch.topo, whose own parity is tests/test_torch_topo.py);
    an abstract topology with no pool raises the reference's errors."""
    sm = SparseMatrix.from_dense(_matrix())
    topo = FakeTopology.pim_like((2, 2), devices=CPU * 4)
    abstract = FakeTopology.pim_like((2, 2))
    tuner = ttune.Tuner(measurer=ttune.FakeMeasurer())
    best = sm.plan(scheme="tune", topology=topo, tuner=tuner)
    assert best.measured["candidates"] >= 2 and best.device.type == "cpu"
    plans = ttune.CandidateGenerator().plans(sm, topology=topo)
    placed = [p.scheme_id.split("@") for p in plans if "@" in p.scheme_id]
    schemes = [sid for sid, _ in placed]  # one candidate per assignment
    assert placed and all(schemes.count(sid) == 2 for sid in schemes)
    assert ttune.topology_key(topology=topo) == "cpu:4|pim2x2:2x2"
    result = tuner.tune(sm, topology=topo)
    assert result.from_cache and result.key.topology == "cpu:4|pim2x2:2x2"
    engine = SpmvEngine(tune=True, topology=topo)
    assert engine.n_devices == 4 and engine.topology is topo
    with pytest.raises(ValueError, match="abstract"):
        sm.plan(scheme="tune", device="cpu", topology=abstract)
    assert ttune.CandidateGenerator().plans(sm, device="cpu",
                                            topology=abstract) == []
    with pytest.raises(RuntimeError, match="zero runnable"):
        tuner.tune(sm, device="cpu", topology=abstract)


# ----------------------------------------------------------- scenarios

class PortFake(ttune.FakeMeasurer):
    """The port's FakeMeasurer, hashing each candidate under its JAX impl
    name, so both packages draw the same pseudo-times."""

    def _fake_time(self, plan) -> float:
        return super()._fake_time(types.SimpleNamespace(
            scheme_id=plan.scheme_id, impl=TO_JAX[plan.impl], grid=plan.grid))


class Side:
    """One package's names, so a scenario runs unchanged on either."""

    def __init__(self, port: bool, impl: str):
        self.port = port
        self.impl = impl if port else TO_JAX[impl]
        self.mod = ttune if port else jtune
        self.SM = SparseMatrix if port else JSparseMatrix
        self.plan_kw = dict(device="cpu", impl=impl) if port else dict(impl=self.impl)

    def fake(self, costs=None, seed=0):
        return (PortFake if self.port else jtune.FakeMeasurer)(costs=costs,
                                                                seed=seed)

    def tuner(self, measurer=None, cache=None, impls=None):
        gen = self.mod.CandidateGenerator(impls=impls or (self.impl,))
        return self.mod.Tuner(generator=gen, measurer=measurer, cache=cache)

    def tune(self, tuner, sm, **kw):
        return tuner.tune(sm, **(dict(device="cpu") if self.port else {}), **kw)

    def cache(self, path):
        return self.mod.TuningCache(path=path)

    def engine(self, **kw):
        if self.port:
            return SpmvEngine(devices=CPU, impl=self.impl, **kw)
        return JEngine(devices=jax.devices()[:1], impl=self.impl, **kw)

    def other_impl(self):
        return {"torch": "cuda", "cuda": "torch", "xla": "pallas",
                "pallas": "xla"}[self.impl]


def _measured(measured: dict) -> dict:
    """A plan's ``measured`` without the port's extra key, which counts the
    candidates planned: every one measured (0 planned on a cache hit)."""
    if "planned" not in measured:
        return measured  # the JAX package's
    measured = dict(measured)
    planned = measured.pop("planned")
    assert planned == (0 if measured["from_cache"] else measured["candidates"])
    return measured


def _result(r) -> dict:
    return {"best": r.best.scheme_id, "impl": r.best.impl,
            "grid": list(r.best.grid), "best_s": r.best_measurement.mean_s,
            "baseline": r.baseline.scheme_id, "baseline_s": r.baseline.mean_s,
            "speedup": r.speedup, "from_cache": r.from_cache,
            "measured": [m.scheme_id for m in r.measurements],
            "plan_measured": _measured(r.best.measured)}


def sc_measured_never_worse(S, tmp_path):
    r = S.tune(S.tuner(S.fake(seed=11)), S.SM.from_dense(_matrix()))
    assert r.best_measurement.mean_s <= r.baseline.mean_s and r.speedup >= 1.0
    assert "measured:" in r.best.describe()
    return _result(r)


def sc_deterministic_under_seeded_fake(S, tmp_path):
    picks = []
    for _ in range(2):
        sm = S.SM.from_dense(_matrix("scale-free"))
        pln = sm.plan(scheme="tune", tuner=S.tuner(S.fake(seed=5)), **S.plan_kw)
        picks.append((pln.scheme_id, pln.impl, pln.grid))
    assert picks[0] == picks[1]
    return picks[0]


def sc_rejects_silent_overrides(S, tmp_path):
    sm = S.SM.from_dense(_matrix())
    out = []
    for kw in ({"fmt": "csr"}, {"partitioning": "2d"}, {"merge": "psum"},
               {"grid": (2, 2)}):
        with pytest.raises(ValueError, match="searches") as e:
            sm.plan(scheme="tune", tuner=S.tuner(S.fake()), **S.plan_kw, **kw)
        out.append(str(e.value).split(";")[0])
    return out


def sc_respects_forced_costs(S, tmp_path):
    costs = {"1d.nnz-rgrn.csr.ppermute": 1e-9}
    pln = S.SM.from_dense(_matrix()).plan(
        scheme="tune", tuner=S.tuner(S.fake(costs=costs)), **S.plan_kw)
    assert pln.scheme_id == "1d.nnz-rgrn.csr.ppermute"
    return [pln.scheme_id, _measured(pln.measured)]


def sc_default_tuner_with_cache_path(S, tmp_path):
    """plan(scheme="tune", tune_cache=path): winners persist; a second call
    reads them (the default tuner, real measurements: the winner's
    identity is compared only through the file's structure)."""
    path = tmp_path / ("port" if S.port else "jax") / "w.json"
    sm = S.SM.from_dense(_matrix())
    first = sm.plan(scheme="tune", tune_cache=str(path), **S.plan_kw)
    second = S.SM.from_dense(_matrix()).plan(scheme="tune", tune_cache=path,
                                             **S.plan_kw)
    assert second.scheme_id == first.scheme_id and second.measured["from_cache"]
    doc = json.loads(path.read_text())
    [record] = doc["entries"].values()
    return {"version": doc["version"], "keys": sorted(record),
            "candidates": [c["scheme_id"] for c in record["candidates"]],
            "impl": record["impl"], "first_cached": first.measured["from_cache"]}


def sc_cache_hit_skips_measurement(S, tmp_path):
    a = _matrix()
    path = tmp_path / ("port" if S.port else "jax") / "winners.json"
    meas1 = S.fake(seed=1)
    r1 = S.tune(S.tuner(meas1, S.cache(path)), S.SM.from_dense(a))
    meas2 = S.fake(seed=1)
    r2 = S.tune(S.tuner(meas2, S.cache(path)), S.SM.from_dense(a))
    assert r2.from_cache and meas2.calls == []
    return {"r1": _result(r1), "r2": _result(r2), "calls1": meas1.calls,
            "calls2": meas2.calls}


def sc_cache_does_not_cross_impls(S, tmp_path):
    path = tmp_path / ("port" if S.port else "jax") / "w.json"
    first = S.tune(S.tuner(S.fake(), S.cache(path)), S.SM.from_dense(_matrix()))
    other = S.tune(S.tuner(S.fake(), S.cache(path), impls=(S.other_impl(),)),
                   S.SM.from_dense(_matrix()))
    assert not other.from_cache and other.best.impl == S.other_impl()
    return {"first": _result(first), "other": _result(other)}


def sc_cache_miss_on_different_matrix(S, tmp_path):
    meas = S.fake()
    tuner = S.tuner(meas, S.cache(tmp_path / ("port" if S.port else "jax")
                                  / "w.json"))
    S.tune(tuner, S.SM.from_dense(_matrix("regular")))
    n = len(meas.calls)
    r = S.tune(tuner, S.SM.from_dense(_matrix("scale-free")))
    assert not r.from_cache and len(meas.calls) > n
    return {"n": n, "calls": meas.calls, "r": _result(r)}


def sc_cache_hit_rebases_baseline(S, tmp_path):
    a = _matrix()
    sm = S.SM.from_dense(a)
    cache = S.cache(tmp_path / ("port" if S.port else "jax") / "w.json")
    first = S.tune(S.tuner(S.fake(seed=2), cache), sm)
    other = next(m for m in first.measurements
                 if m is not first.best_measurement)
    inc_plan = sm.plan(scheme=other.scheme_id.rsplit(".", 2)[0], fmt=other.fmt,
                       **S.plan_kw).scheme
    meas2 = S.fake(seed=2)
    r2 = S.tune(S.tuner(meas2, cache), S.SM.from_dense(a),
                baseline=(inc_plan, S.impl))
    assert r2.from_cache and meas2.calls == []
    assert r2.baseline.scheme_id == other.scheme_id
    assert r2.baseline.mean_s == pytest.approx(other.mean_s)
    return {"first": _result(first), "r2": _result(r2)}


def sc_cache_bypassed_without_incumbent(S, tmp_path):
    cache = S.cache(tmp_path / ("port" if S.port else "jax") / "w.json")
    a = _matrix()
    S.tune(S.tuner(S.fake(), cache), S.SM.from_dense(a))
    sm = S.SM.from_dense(a)
    unmeasured = sm.plan(scheme="2d.variable-sized", **S.plan_kw).scheme
    meas = S.fake()
    r = S.tune(S.tuner(meas, cache), sm, baseline=(unmeasured, S.impl))
    assert not r.from_cache and meas.calls
    return {"r": _result(r), "calls": meas.calls}


def _event(e) -> dict:
    assert e.get("candidates") == e.get("planned")
    return {k: v for k, v in e.items() if k not in ("candidates", "planned")}


def _events(eng, meas=None) -> list:
    """Tune events without the port's extra keys, which count the
    candidates measured and planned: the two are equal, and the measured
    ones are checked here against the measurer's calls."""
    if isinstance(eng, SpmvEngine) and meas is not None:
        assert sum(e.get("candidates", 0) for e in eng.tune_events) == \
            len(meas.calls)
    return [_event(e) for e in eng.tune_events]


def sc_engine_refine_swaps_to_forced_winner(S, tmp_path):
    meas = S.fake(costs={"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng = S.engine(cache_capacity=4, tune=True, tuner=S.tuner(meas))
    a = _matrix()
    eng.register("m", a)
    event = eng.refine("m")
    assert event["swapped"]
    entry = eng.registry.get("m")
    x = _x(a.shape[1])
    y = np.asarray(eng.multiply("m", x))
    np.testing.assert_array_equal(y, a @ x)
    return {"event": _event(event), "key": list(entry.cache_key[1:]),
            "tuned": entry.tuned, "y": y, "Y": np.asarray(
                eng.multiply("m", _x(a.shape[1], 4))),
            "calls": meas.calls, "cache": len(eng.cache)}


def sc_engine_keeps_incumbent_inside_margin(S, tmp_path):
    meas = S.fake()
    meas._fake_time = lambda plan: 1e-3  # nothing clears the 0.9 margin
    eng = S.engine(cache_capacity=4, tune=True, tuner=S.tuner(meas))
    eng.register("m", _matrix())
    before = eng.registry.get("m").cache_key
    event = eng.refine("m")
    assert not event["swapped"] and eng.registry.get("m").cache_key == before
    return {"event": _event(event), "tuned": eng.registry.get("m").tuned}


def sc_engine_background_refine_off_live_traffic(S, tmp_path):
    meas = S.fake(costs={"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng = S.engine(cache_capacity=4, tune=True, tuner=S.tuner(meas),
                   tune_after=3)
    a = _matrix()
    eng.register("m", a)
    x = _x(a.shape[1])
    for _ in range(4):
        eng.multiply("m", x)
    eng.drain_tuning(timeout=TIMEOUT)
    assert eng.tune_events and eng.tune_events[0]["swapped"]
    y = np.asarray(eng.multiply("m", x))
    np.testing.assert_array_equal(y, a @ x)
    entry = eng.registry.get("m")
    return {"events": _events(eng, meas), "tuned": entry.tuned, "y": y,
            "key": list(entry.cache_key[1:]), "requests": entry.requests,
            "ewma": entry.batch_ewma, "tuned_batch": entry.tuned_batch}


def sc_engine_refine_is_one_shot(S, tmp_path):
    meas = S.fake()
    eng = S.engine(cache_capacity=4, tune=True, tuner=S.tuner(meas),
                   tune_after=2)
    a = _matrix()
    eng.register("m", a)
    x = _x(a.shape[1])
    for _ in range(6):
        eng.multiply("m", x)
    eng.drain_tuning(timeout=TIMEOUT)
    assert len(eng.tune_events) == 1
    return {"events": _events(eng, meas), "calls": meas.calls}


def sc_engine_swap_keeps_other_matrices(S, tmp_path):
    meas = S.fake(costs={"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng = S.engine(cache_capacity=4, tune=True, tuner=S.tuner(meas))
    eng.cache.capacity = 2
    a1, a2 = _matrix("regular"), _matrix("scale-free")
    eng.register("m1", a1)
    eng.register("m2", a2)
    eng.multiply("m1", _x(128))  # m2 is now the LRU entry
    event = eng.refine("m1")
    assert event["swapped"] and eng.plan_for("m2") is not None
    y2 = np.asarray(eng.multiply("m2", _x(128, seed=2)))
    np.testing.assert_array_equal(y2, a2 @ _x(128, seed=2))
    assert eng.plan_for("m1") is not None and len(eng.cache) == 2
    return {"event": _event(event), "y2": y2,
            "y1": np.asarray(eng.multiply("m1", _x(128, seed=3))),
            "keys": [list(k[1:]) for k in eng.cache.keys()]}


def sc_engine_failing_refinement_does_not_respawn(S, tmp_path):
    class Boom:
        def tune(self, *a, **k):
            raise RuntimeError("measurement exploded")

    eng = S.engine(cache_capacity=4, tune=True, tuner=Boom(), tune_after=2)
    a = _matrix()
    eng.register("m", a)
    x = _x(a.shape[1])
    for _ in range(6):
        eng.multiply("m", x)
    eng.drain_tuning(timeout=TIMEOUT)
    assert len(eng.tune_events) == 1 and "error" in eng.tune_events[0]
    y = np.asarray(eng.multiply("m", x))
    np.testing.assert_array_equal(y, a @ x)
    return {"events": _events(eng), "tuned": eng.registry.get("m").tuned, "y": y}


def sc_engine_tune_margin_validation(S, tmp_path):
    out = []
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError) as e:
            S.engine(tune=True, tune_margin=bad)
        out.append(str(e.value))
    return out


def _drift_matrix():
    """tests/test_serve.py's regular matrix, integer-valued."""
    return _ints(jmat.regular_matrix(64, 96, 5, seed=1))


def sc_drift_retune_triggers_second_refinement(S, tmp_path):
    meas = S.fake()
    eng = S.engine(cache_capacity=4, tune=True, tune_after=3,
                   tuner=S.tuner(meas), drift_factor=2.0, drift_alpha=1.0)
    a = _drift_matrix()
    eng.register("m", a)
    x, X = _x(96, seed=3), _x(96, 8, seed=4)
    for _ in range(4):  # qualify + first (traffic-triggered) refinement
        eng.multiply("m", x)
    eng.drain_tuning(timeout=TIMEOUT)
    assert [e["trigger"] for e in eng.tune_events] == ["traffic"]
    first = eng.registry.get("m").tuned_batch
    for _ in range(3):  # sustained 8-wide traffic: 8x drift >= factor 2
        eng.multiply("m", X)
    eng.drain_tuning(timeout=TIMEOUT)
    assert [e["trigger"] for e in eng.tune_events] == ["traffic", "drift"]
    Y = np.asarray(eng.multiply("m", X))
    np.testing.assert_array_equal(Y, a @ X)
    return {"events": _events(eng, meas), "first": first,
            "second": eng.registry.get("m").tuned_batch, "Y": Y,
            "key": list(eng.registry.get("m").cache_key[1:])}


def sc_drift_failing_refinement_one_shot_per_regime(S, tmp_path):
    calls = []

    class Broken:
        def tune(self, *a, **kw):
            calls.append(kw.get("batch"))
            raise RuntimeError("no runnable candidates")

    eng = S.engine(cache_capacity=4, tune=True, tune_after=2, tuner=Broken(),
                   drift_factor=2.0, drift_alpha=1.0)
    eng.register("m", _drift_matrix())
    for _ in range(3):  # qualify -> first refinement fails
        eng.multiply("m", np.zeros(96, np.float32))
    eng.drain_tuning(timeout=TIMEOUT)
    for _ in range(6):  # new drift regime: exactly ONE more failing attempt
        eng.multiply("m", np.zeros((96, 8), np.float32))
        eng.drain_tuning(timeout=TIMEOUT)
    assert len(calls) == 2 and len(eng.tune_events) == 2
    return {"events": _events(eng), "calls": calls}


def sc_drift_disabled_with_none_factor(S, tmp_path):
    meas = S.fake()
    eng = S.engine(cache_capacity=4, tune=True, tune_after=2,
                   tuner=S.tuner(meas), drift_factor=None)
    eng.register("m", _drift_matrix())
    for _ in range(3):
        eng.multiply("m", np.zeros(96, np.float32))
    eng.drain_tuning(timeout=TIMEOUT)
    for _ in range(3):
        eng.multiply("m", np.zeros((96, 8), np.float32))
    eng.drain_tuning(timeout=TIMEOUT)
    assert len(eng.tune_events) == 1
    return {"events": _events(eng, meas)}


TUNER_SCENARIOS = [sc_measured_never_worse, sc_deterministic_under_seeded_fake,
                   sc_rejects_silent_overrides, sc_respects_forced_costs,
                   sc_cache_hit_skips_measurement, sc_cache_does_not_cross_impls,
                   sc_cache_miss_on_different_matrix, sc_cache_hit_rebases_baseline,
                   sc_cache_bypassed_without_incumbent]
ENGINE_SCENARIOS = [sc_engine_refine_swaps_to_forced_winner,
                    sc_engine_keeps_incumbent_inside_margin,
                    sc_engine_background_refine_off_live_traffic,
                    sc_engine_refine_is_one_shot,
                    sc_engine_swap_keeps_other_matrices,
                    sc_engine_failing_refinement_does_not_respawn,
                    sc_engine_tune_margin_validation,
                    sc_drift_retune_triggers_second_refinement,
                    sc_drift_failing_refinement_one_shot_per_regime,
                    sc_drift_disabled_with_none_factor]
SCENARIOS = ([(sc, impl) for sc in TUNER_SCENARIOS for impl in ("torch", "cuda")]
             + [(sc, "torch") for sc in ENGINE_SCENARIOS]
             + [(sc_engine_refine_swaps_to_forced_winner, "cuda"),
                (sc_drift_retune_triggers_second_refinement, "cuda")])


@pytest.mark.parametrize("scenario,impl", SCENARIOS,
                         ids=[f"{sc.__name__[3:]}-{i}" for sc, i in SCENARIOS])
def test_scenario_matches_jax(tmp_path, scenario, impl):
    want = scenario(Side(port=False, impl=impl), tmp_path)
    got = scenario(Side(port=True, impl=impl), tmp_path)
    _assert_same(_jaxify(got), want)


def test_default_tuner_and_cache_path(tmp_path):
    """plan(scheme="tune", tune_cache=...) with the default (real) tuner on
    both packages: the same file layout and candidates; the winner itself
    is a wall-clock outcome and is not compared."""
    got = sc_default_tuner_with_cache_path(Side(port=True, impl="torch"),
                                           tmp_path)
    want = sc_default_tuner_with_cache_path(Side(port=False, impl="torch"),
                                            tmp_path)
    assert _jaxify(got) == want


# ----------------------------------------------------------- port-only


def _forced_engine(costs, **kw):
    return SpmvEngine(devices=CPU, impl="torch", cache_capacity=4, tune=True,
                      tuner=ttune.Tuner(
                          generator=ttune.CandidateGenerator(impls=("torch",)),
                          measurer=ttune.FakeMeasurer(costs=costs)), **kw)


def test_last_x_is_a_snapshot_the_caller_cannot_mutate():
    a = _matrix()
    for make in (lambda v: v, torch.from_numpy):
        eng = _forced_engine({"1d.nnz-rgrn.csr.ppermute": 1e-9}, tune_after=1)
        eng.register("m", a)
        x = make(_x(128))
        eng.multiply("m", x)
        entry = eng.registry.get("m")
        eng.drain_tuning(timeout=TIMEOUT)
        assert entry.last_x is not x and entry.last_x_ready is None
        want = np.array(entry.last_x)
        x[:] = 99  # the caller reuses its buffer
        np.testing.assert_array_equal(np.asarray(entry.last_x), want)
        assert eng.tune_events[0]["swapped"] and eng.tune_events[0]["candidates"] == 5


def test_request_racing_a_swap_reruns_on_the_winner():
    """A refinement swaps the plan out between a request's lookup and its
    launch: the request answers from the winner, with one record."""
    a = _matrix()
    eng = _forced_engine({"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng.register("m", a)
    old = eng.plan_for("m")
    place = old.executor.place

    def place_then_swap(x):
        xs = place(x)
        if not eng.tune_events:
            eng.refine("m")  # releases `old` before its run_raw
        return xs

    old.executor.place = place_then_swap
    x = _x(128)
    records = len(eng.telemetry.records)
    np.testing.assert_array_equal(eng.multiply("m", x), a @ x)
    assert eng.tune_events[0]["swapped"] and old.arrays is None
    assert eng.registry.get("m").cache_key[3] == "1d.nnz-rgrn.csr.ppermute"
    assert len(eng.telemetry.records) == records + 1


def test_evicted_plan_still_raises_without_a_swap():
    """Only a swap reruns a request: a plan evicted under it raises."""
    eng = _forced_engine({})
    eng.register("m", _matrix())
    cp = eng.plan_for("m")
    place = cp.executor.place

    def place_then_evict(x):
        xs = place(x)
        eng.cache.evict(cp.key)
        return xs

    cp.executor.place = place_then_evict
    with pytest.raises(RuntimeError, match="released"):
        eng.multiply("m", _x(128))


def test_kernel_error_racing_a_swap_raises():
    """Only a released executor reruns: a kernel error on a plan that a
    swap has just replaced reaches the caller."""
    eng = _forced_engine({"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng.register("m", _matrix())
    old = eng.plan_for("m")

    def swap_then_fail(xs):
        eng.refine("m")
        raise RuntimeError("kernel fault")

    old.executor.run_raw = swap_then_fail
    with pytest.raises(RuntimeError, match="kernel fault"):
        eng.multiply("m", _x(128))
    assert eng.tune_events[0]["swapped"]


def test_session_racing_a_swap_reruns_on_the_winner():
    """A refinement swaps the plan out between a session's lookup and its
    loop: the session runs on the winner, with one record."""
    a = _ints(jmat.regular_matrix(64, 64, 5, seed=1))
    eng = _forced_engine({"1d.nnz-rgrn.csr.ppermute": 1e-9})
    eng.register("sq", a)
    old = eng.plan_for("sq")
    lookup = eng._compiled

    def lookup_then_swap(entry):
        cp = lookup(entry)
        if not eng.tune_events:
            eng.refine("sq")  # releases `old` before its loop
        return cp

    eng._compiled = lookup_then_swap
    x = want = _x(64)
    for _ in range(3):
        want = a @ want
    records = len(eng.telemetry.records)
    result = eng.solve("sq", x, steps=3)
    np.testing.assert_array_equal(result.x, want)
    assert eng.tune_events[0]["swapped"] and old.arrays is None
    assert eng.registry.get("sq").cache_key[3] == "1d.nnz-rgrn.csr.ppermute"
    assert len(eng.telemetry.records) == records + 1


class _PlannedOn:
    """CandidateGenerator whose plans claim to run on ``device`` (never
    compiled: the measurer below raises for the chosen candidate)."""

    def __init__(self, impl, device):
        self.impls = (impl,)
        self.inner = ttune.CandidateGenerator(impls=(impl,))
        self.device = torch.device(device)

    def plans(self, matrix, **kw):
        return [dataclasses.replace(p, device=self.device)
                for p in self.inner.plans(matrix, **kw)]


class _FailsOne(ttune.FakeMeasurer):
    def measure(self, plan, x=None):
        if plan.scheme_id == "1d.nnz-rgrn.csr.ppermute":
            raise RuntimeError("kernel failed to launch")
        return super().measure(plan, x)


@pytest.mark.parametrize("impl,device,raises", [
    ("cuda", "cuda", True), ("torch", "cuda", False), ("cuda", "cpu", False)])
def test_raising_kernel_candidate_on_the_card_propagates(impl, device, raises):
    """A ``cuda`` candidate on a CUDA device that raises is a fault the
    tuner reports; any other candidate that raises is dropped, as in the
    JAX package."""
    sm = SparseMatrix.from_dense(_matrix())
    tuner = ttune.Tuner(generator=_PlannedOn(impl, device),
                        measurer=_FailsOne())
    if raises:
        with pytest.raises(RuntimeError, match="failed to launch"):
            tuner.tune(sm, device="cpu")
        return
    r = tuner.tune(sm, device="cpu")
    assert r.planned == len(r.measurements) + 1
    assert "1d.nnz-rgrn.csr.ppermute" not in {m.scheme_id for m in r.measurements}


def test_refinements_swap_under_many_threads():
    """Stress: 8 threads multiply while a refiner swaps the plan back and
    forth 12 times, with a short switch interval; every answer exact."""
    a = _matrix("block")
    tuner = ttune.Tuner(generator=ttune.CandidateGenerator(impls=("torch",)),
                        measurer=ttune.FakeMeasurer())
    eng = SpmvEngine(devices=CPU, impl="torch", cache_capacity=2, tune=True,
                     tune_after=10**9,  # refinements come from the refiner only
                     tuner=tuner)
    eng.register("m", a)
    xs = [_x(128, None if i % 2 else 4, seed=i) for i in range(8)]
    wants = [a @ x for x in xs]
    errors, answered = [], [0] * len(xs)
    stop = threading.Event()

    def client(i):
        try:
            while not stop.is_set():
                np.testing.assert_array_equal(eng.multiply("m", xs[i]), wants[i])
                answered[i] += 1
        except Exception as e:  # reported below
            errors.append(repr(e))

    def refiner():
        try:
            for k in range(12):
                tuner.measurer.costs = {"2d.equally-sized.bcoo.psum_scatter"
                                        if k % 2 else "1d.nnz.coo.ppermute": 1e-9}
                tuner.cache.clear()  # measure anew: the winner changed
                eng.refine("m")
        except Exception as e:
            errors.append(repr(e))
        finally:
            stop.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        threads.append(threading.Thread(target=refiner))
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert errors == []
    assert [e["swapped"] for e in eng.tune_events] == [True] * 12
    assert all(n > 0 for n in answered)
    assert len(eng.cache) == 1  # each swap evicted its incumbent


def test_refine_measures_on_the_last_request_with_the_default_tuner():
    """The default background tuner (real Measurer, warmup 1, iters 3) on
    the CPU, at width 8: candidates of the engine's impl, timed on the
    triggering request."""
    a = _matrix("block")
    eng = SpmvEngine(devices=CPU, impl="cuda", tune=True, tune_after=8)
    eng.register("m", a)
    X = _x(128, 8)
    eng.multiply("m", X)
    eng.drain_tuning(timeout=TIMEOUT)
    [event] = eng.tune_events
    assert "error" not in event and event["batch"] == 8
    assert event["trigger"] == "traffic" and event["candidates"] >= 5
    tuner = eng._tuner
    assert tuner.generator.impls == ("cuda",)
    assert (tuner.measurer.warmup, tuner.measurer.iters) == (1, 3)
    np.testing.assert_array_equal(eng.multiply("m", X), a @ X)


def test_solve_does_not_trigger_refinement():
    """As in the JAX engine, solver sessions feed no tuning."""
    a = _ints(jmat.regular_matrix(64, 64, 5, seed=1))
    eng = _forced_engine({"1d.nnz-rgrn.csr.ppermute": 1e-9}, tune_after=1)
    eng.register("sq", a)
    for _ in range(3):
        eng.solve("sq", _x(64), steps=2)
    eng.drain_tuning(timeout=TIMEOUT)
    assert eng.tune_events == [] and eng.registry.get("sq").batch_ewma is None
