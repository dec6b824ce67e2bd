"""repro_torch.engine against repro.engine, on the same seeded inputs.

One device, in process: the JAX ``SpmvEngine(impl="xla")`` and
``impl="pallas"`` (interpret mode, as tests/test_engine.py runs it) next to
the port's ``SpmvEngine(devices=["cpu"], impl="torch")`` and
``impl="cuda"`` (the kernels' plain versions on the CPU).  Plan keys
(impl names mapped ``torch``<->``xla``, ``cuda``<->``pallas``), fitted plans
and answers must be equal: bit for bit on integer-valued float32, within
2e-4 on random float32 (the tolerance of tests/test_kernels.py: sums run in
another order).

Four parts: the JAX engine on 4 fake devices in a subprocess
(tests/_torch_engine_runner.py, once per module) against the port's
``SpmvEngine(devices=["cpu"] * 4)``, 1d and 2d plans.

The rest mirrors tests/test_engine.py on the port: plan cache counters,
LRU eviction (which must drop the placed tensors), re-registration,
dtype/shape errors, the batcher (its batch formation held against the JAX
batcher's on a recording stand-in engine), and the pieces not ported yet
raising ``NotImplementedError``.  Every batcher wait is bounded and every
background thread is stopped in a ``finally``.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.adaptive import Plan as JPlan
from repro.data.matrices import block_matrix, regular_matrix, scale_free_matrix
from repro.engine import MicroBatcher as JMicroBatcher
from repro.engine import SpmvEngine as JEngine
from repro.engine import fingerprint_matrix as jfingerprint
from repro_torch.api import SparseMatrix
from repro_torch.core.adaptive import Plan
from repro_torch.engine import (CompiledPlan, MicroBatcher, PlanCache,
                                SpmvEngine, fingerprint_matrix)
from repro_torch.kernels import instrument
from repro_torch.topo import FakeTopology

from _torch_engine_cases import (BATCHER, CASES, PARTS, case_id, matrices,
                                 vectors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TO_JAX = {"torch": "xla", "cuda": "pallas"}
CPU = ["cpu"]
TIMEOUT = 30  # seconds any future or thread is waited for


def _float_mats():
    """tests/test_engine.py's matrices (random float32 values)."""
    return {
        "regular": regular_matrix(96, 128, 5, seed=1),
        "scale-free": scale_free_matrix(96, 128, 600, seed=2),
        "block": block_matrix(96, 128, block=(8, 16), block_density=0.2,
                              seed=3),
    }


def _inputs(values: str):
    if values == "int":
        mats, vecs = matrices(), vectors()
        return mats, vecs["x"], vecs["X"]
    rng = np.random.default_rng(7)
    return (_float_mats(), rng.standard_normal(128).astype(np.float32),
            rng.standard_normal((128, 8)).astype(np.float32))


def _plan_fields(p) -> list:
    return [p.partitioning, p.scheme, p.fmt, p.merge, list(p.grid), p.reason]


def _same(got, want, exact: bool, what: str = ""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=what)


@pytest.fixture(scope="module")
def jax_one_device():
    """The JAX engine's keys, plans and answers, one device, per impl."""
    out = {}
    for jimpl in ("xla", "pallas"):
        for values in ("int", "rand"):
            mats, x, X = _inputs(values)
            eng = JEngine(devices=jax.devices()[:1], impl=jimpl)
            for name, a in mats.items():
                entry = eng.register(name, a)
                out[(jimpl, values, name)] = dict(
                    key=entry.cache_key, plan=_plan_fields(entry.plan),
                    y=np.asarray(eng.multiply(name, x)),
                    Y=np.asarray(eng.multiply(name, X)))
    return out


@pytest.mark.parametrize("values", ["int", "rand"])
@pytest.mark.parametrize("name", ["regular", "scale-free", "block"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_engine_matches_jax_one_device(jax_one_device, impl, name, values):
    want = jax_one_device[(TO_JAX[impl], values, name)]
    mats, x, X = _inputs(values)
    eng = SpmvEngine(devices=CPU, impl=impl)
    entry = eng.register(name, mats[name])
    key = entry.cache_key
    assert key[:4] == tuple(want["key"][:4])
    assert TO_JAX[key[4]] == want["key"][4]
    assert _plan_fields(entry.plan) == want["plan"]
    exact = values == "int"
    _same(eng.multiply(name, x), want["y"], exact, "y")
    _same(eng.multiply(name, X), want["Y"], exact, "Y")
    # the same multiply, asked with a tensor
    _same(eng.multiply(name, torch.from_numpy(X)), want["Y"], exact,
          "Y tensor")


DTYPES = {"bf16": (jax.numpy.bfloat16, torch.bfloat16), "i8": (np.int8, torch.int8)}


@pytest.fixture(scope="module")
def jax_dtypes():
    """The JAX engine's keys and answers for bf16 and int8 registrations."""
    mats, vecs = matrices(), vectors()
    out = {}
    for jimpl in ("xla", "pallas"):
        eng = JEngine(devices=jax.devices()[:1], impl=jimpl)
        for dt, (jdt, _) in DTYPES.items():
            for name in ("regular", "block"):
                entry = eng.register(f"{name}.{dt}", mats[name], dtype=jdt)
                x = vecs["x"].astype(jdt)
                out[(jimpl, dt, name)] = dict(
                    key=entry.cache_key,
                    y=np.asarray(eng.multiply(f"{name}.{dt}", x)))
    return out


@pytest.mark.parametrize("name", ["regular", "block"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_engine_dtypes_match_jax(jax_dtypes, impl, dt, name):
    """bf16 and int8 registrations (``dtype=`` on a dense matrix): the same
    key and the same answer, in the JAX package's result dtype, bit for
    bit (integer values)."""
    want = jax_dtypes[(TO_JAX[impl], dt, name)]
    jdt, tdt = DTYPES[dt]
    eng = SpmvEngine(devices=CPU, impl=impl)
    entry = eng.register(name, matrices()[name], dtype=tdt)
    assert entry.cache_key[:4] == tuple(want["key"][:4])
    y = eng.multiply(name, vectors()["x"].astype(jdt))
    assert y.dtype == want["y"].dtype
    np.testing.assert_array_equal(y.astype(np.float32),
                                  want["y"].astype(np.float32))


# ------------------------------------------------------------------ 4 parts


@pytest.fixture(scope="module")
def jax_four_parts(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_engine_runner.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    if proc.returncode != 0:
        pytest.fail(f"engine runner crashed:\n{proc.stderr[-3000:]}")
    if "ENGINE SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def port_four_parts():
    """One port engine per impl over 4 parts on the CPU."""
    return {impl: SpmvEngine(devices=CPU * PARTS, impl=impl, cache_capacity=16)
            for impl in ("torch", "cuda")}


FOUR_PART_CASES = [(c, impl) for c in CASES for impl in
                   (("torch", "cuda") if c[2] == "xla" else ("cuda",))]


@pytest.mark.parametrize("case,impl", FOUR_PART_CASES,
                         ids=[f"{case_id(*c)}-{i}" for c, i in FOUR_PART_CASES])
def test_engine_matches_jax_on_4_parts(jax_four_parts, port_four_parts, case,
                                       impl):
    matrix, part, jimpl = case
    cid = case_id(*case)
    eng = port_four_parts[impl]
    mats, vecs = matrices(), vectors()
    entry = eng.register(cid, mats[matrix], partitioning=part)
    want_key = json.loads(str(jax_four_parts[f"{cid}|key"]))
    want_key[1] = tuple(want_key[1])
    assert entry.cache_key[:4] == tuple(want_key[:4])
    if TO_JAX[impl] == jimpl:
        assert TO_JAX[entry.cache_key[4]] == want_key[4]
    want_plan = json.loads(str(jax_four_parts[f"{cid}|plan"]))
    assert _plan_fields(entry.plan) == want_plan
    assert entry.plan.partitioning == part
    for name in ("x", "X", "x_rand"):
        _same(eng.multiply(cid, vecs[name]), jax_four_parts[f"{cid}|{name}"],
              name != "x_rand", f"{cid} {impl} {name}")


def test_batcher_matches_jax_on_4_parts(jax_four_parts):
    matrix, part, n = BATCHER
    eng = SpmvEngine(devices=CPU * PARTS)
    name = case_id(matrix, part, "xla")
    eng.register(name, matrices()[matrix], partitioning=part)
    mb = MicroBatcher(eng, max_batch=4, buckets=(1, 2, 4), auto_flush=False)
    futs = [mb.submit(name, v) for v in vectors()["batcher"]]
    assert mb.flush() == n
    got = np.stack([f.result(timeout=TIMEOUT) for f in futs])
    np.testing.assert_array_equal(got, jax_four_parts["batcher|y"])
    assert (mb.batches_run, mb.vectors_run) == (1, n)


# ------------------------------------------------------------- one engine


def _mats():
    return _float_mats()


@pytest.fixture()
def engine():
    return SpmvEngine(devices=CPU, cache_capacity=4)


def test_multiply_is_build_and_partition_free_when_cached(engine):
    a = _mats()["regular"]
    engine.register("m", a)
    x = np.zeros(a.shape[1], np.float32)
    engine.multiply("m", x)
    builds, parts = engine.trace_count("m"), engine.partition_count
    for _ in range(5):
        engine.multiply("m", x)
    assert engine.trace_count("m") == builds == 1
    assert engine.partition_count == parts == 1
    assert all(r.traced is False for r in engine.telemetry.records[-5:])


def test_unsafe_dtype_cast_is_rejected(engine):
    a = np.zeros((8, 8), np.int8)
    a[0, 0], a[3, 4] = 2, 5
    engine.register("int8", a)
    with pytest.raises(TypeError, match="cannot safely cast"):
        engine.multiply("int8", np.full(8, 0.5, np.float32))
    y = engine.multiply("int8", np.ones(8, np.int8))
    np.testing.assert_array_equal(y, a @ np.ones(8, np.int8))


def test_2d_unfit_bcsr_plan_falls_back_to_bcoo(engine):
    engine.devices = engine.devices * 3  # neither (1,3) nor (3,1) fits
    plan = Plan("2d", "equally-sized", "bcsr", "psum", (1, 3), "forced")
    fitted = engine._fit_plan(plan, (8, 16), np.float32)
    jeng = JEngine(devices=jax.devices()[:1] * 3)
    want = jeng._fit_plan(JPlan("2d", "equally-sized", "bcsr", "psum", (1, 3),
                                "forced"), (8, 16), np.float32)
    assert _plan_fields(fitted) == _plan_fields(want)
    assert (fitted.partitioning, fitted.fmt, fitted.scheme) == ("1d", "bcoo", "nnz")


def test_cache_hit_marks_first_serve_false(engine):
    a = _mats()["regular"]
    engine.register("m", a, warmup=False)
    engine.multiply("m", np.zeros(a.shape[1], np.float32))
    engine.multiply("m", np.zeros(a.shape[1], np.float32))
    assert [r.cache_hit for r in engine.telemetry.records] == [False, True]


def test_unknown_name_and_bad_shape(engine):
    with pytest.raises(KeyError):
        engine.multiply("nope", np.zeros(4, np.float32))
    engine.register("m", _mats()["regular"])
    with pytest.raises(ValueError):
        engine.multiply("m", np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="2D"):
        engine.register("v", np.zeros(8, np.float32))


def test_cache_hit_and_miss_counters(engine):
    a = _mats()["regular"]
    engine.register("m", a, warmup=False)
    s0 = engine.cache.stats
    assert s0.misses == 1 and s0.size == 1
    engine.multiply("m", np.zeros(a.shape[1], np.float32))
    assert engine.cache.stats.hits == s0.hits + 1


def test_reregister_identical_matrix_reuses_executable(engine):
    a = _mats()["regular"]
    engine.register("m1", a)
    cp1 = engine.plan_for("m1")
    parts = engine.partition_count
    engine.register("m2", a.copy())  # same fingerprint, other name
    assert engine.plan_for("m2") is cp1
    assert engine.partition_count == parts
    assert engine.cache.stats.evictions == 0


def test_fingerprint_matches_jax_and_is_sensitive():
    a = _mats()["regular"]
    b = a.copy()
    ri, ci = np.nonzero(b)
    b[ri[0], ci[0]] += 1.0
    assert fingerprint_matrix(a) == jfingerprint(a)
    assert fingerprint_matrix(b) == jfingerprint(b) != fingerprint_matrix(a)


def test_lru_eviction_at_capacity():
    eng = SpmvEngine(devices=CPU, cache_capacity=2)
    mats = _mats()
    eng.register("a", mats["regular"], warmup=False)
    eng.register("b", mats["scale-free"], warmup=False)
    key_a = eng.registry.get("a").cache_key
    eng.multiply("a", np.zeros(128, np.float32))  # touch a: b becomes LRU
    key_b = eng.registry.get("b").cache_key
    eng.register("c", mats["block"], warmup=False)  # overflows capacity 2
    assert eng.cache.stats.evictions == 1
    assert key_b not in eng.cache and key_a in eng.cache
    with pytest.raises(RuntimeError, match="evicted"):
        eng.multiply("b", np.zeros(128, np.float32))


def test_eviction_drops_the_placed_tensors():
    eng = SpmvEngine(devices=CPU, cache_capacity=1)
    mats = _mats()
    eng.register("a", mats["regular"], warmup=False)
    cp = eng.plan_for("a")
    assert cp.arrays and all(isinstance(t, torch.Tensor)
                             for t in cp.arrays.values())
    eng.register("b", mats["scale-free"], warmup=False)  # evicts a's plan
    assert cp.arrays is None and cp.executor.arrays is None
    with pytest.raises(RuntimeError, match="released"):
        cp.executor.run_raw(torch.zeros(128))
    x = np.ones(128, np.float32)
    np.testing.assert_allclose(eng.multiply("b", x), mats["scale-free"] @ x,
                               rtol=2e-4, atol=2e-4)


def test_plan_cache_unit():
    def entry(i):
        return CompiledPlan(
            key=(f"fp{i}", (1, 1), "<f4", "s", "cuda"), plan=None, part=None,
            arrays=None, run=None, mesh=None, axes=(), x_spec=None, x_pad=0,
            trace_count_fn=lambda: 0)

    cache = PlanCache(capacity=2)
    assert cache.get(entry(0).key) is None  # miss
    cache.put(entry(0))
    cache.put(entry(1))
    assert cache.get(entry(0).key) is not None  # hit; 1 is now LRU
    evicted = cache.put(entry(2))
    assert evicted is not None and evicted.key[0] == "fp1"
    st = cache.stats
    assert (st.hits, st.misses, st.evictions, st.size) == (1, 1, 1, 2)
    assert 0.0 < st.hit_rate < 1.0
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


def test_reregister_name_with_new_matrix_evicts_old_plan(engine):
    mats = _mats()
    engine.register("m", mats["regular"])
    old_key = engine.registry.get("m").cache_key
    engine.register("m", mats["scale-free"])
    assert engine.registry.get("m").cache_key != old_key
    assert old_key not in engine.cache
    x = np.ones(128, np.float32)
    np.testing.assert_allclose(engine.multiply("m", x), mats["scale-free"] @ x,
                               rtol=2e-4, atol=2e-4)


def test_register_sparse_matrix_equals_dense(engine):
    """The one departure: a SparseMatrix (e.g. from triplets) registers as
    its dense array does — the same key, so the same cached plan."""
    a = matrices()["block"]
    dense = engine.register("dense", a)
    ri, ci = np.nonzero(a)
    sm = SparseMatrix.from_parts(ri, ci, a[ri, ci], a.shape)
    parts = engine.partition_count
    sparse = engine.register("sparse", sm)
    assert sparse.cache_key == dense.cache_key
    assert engine.partition_count == parts  # cache hit: nothing rebuilt
    x = vectors()["X"]
    np.testing.assert_array_equal(engine.multiply("sparse", x), a @ x)


def test_register_sparse_matrix_with_dtype_never_densifies(engine):
    a = matrices()["regular"]
    ri, ci = np.nonzero(a)
    sm = SparseMatrix.from_parts(ri, ci, a[ri, ci], a.shape)
    entry = engine.register("bf", sm, dtype=torch.bfloat16)
    want = JEngine(devices=jax.devices()[:1]).register("bf", a,
                                                       dtype=jax.numpy.bfloat16)
    assert entry.cache_key[:4] == want.cache_key[:4]
    assert entry.matrix._dense is None and sm._dense is None


def test_eviction_spills_partition_and_reactivates_cheaply():
    eng = SpmvEngine(devices=CPU, cache_capacity=1)
    mats = _mats()
    eng.register("a", mats["regular"], warmup=False)
    eng.register("b", mats["scale-free"], warmup=False)  # evicts a's plan
    entry = eng.registry.get("a")
    assert entry.spill is not None
    parts = eng.partition_count
    eng.reactivate("a", warmup=False)
    assert eng.partition_count == parts and entry.spill is None
    x = np.ones(128, np.float32)
    np.testing.assert_allclose(eng.multiply("a", x), mats["regular"] @ x,
                               rtol=2e-4, atol=2e-4)
    # reactivating a evicted b: b re-registers from its kept matrix and
    # spilled partition, nothing rebuilt from dense or re-partitioned
    assert eng.registry.get("b").spill is not None
    entry_b = eng.register("b", warmup=False)
    assert eng.partition_count == parts and entry_b.cache_key in eng.cache


def test_register_without_matrix_requires_prior_entry(engine):
    with pytest.raises(ValueError, match="prior registration"):
        engine.register("ghost")


def _solve_agrees_with_jax(engine):
    """``solve`` is ported: a session on a square matrix equals the JAX
    engine's, bit for bit on integer values, and leaves one solve record."""
    a = matrices()["regular"][:, :96]  # square; 4 steps stay exact
    x0 = np.random.default_rng(5).integers(-3, 4, 96).astype(np.float32)
    engine.register("sq", a, warmup=False)
    got = engine.solve("sq", x0, steps=4, combine="plain")
    jeng = JEngine(devices=jax.devices()[:1])
    jeng.register("sq", a)
    want = jeng.solve("sq", x0, steps=4, combine="plain")
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    assert got.steps == want.steps == 4
    assert engine.telemetry.last_solve("sq").steps == 4
    with pytest.raises(ValueError, match="square"):  # as the JAX engine
        engine.solve("m", np.zeros(128, np.float32), steps=2)


def _refine_works(engine):
    event = engine.refine("m")
    assert "error" not in event and event["candidates"] >= 1
    assert engine.registry.get("m").tuned


def _topology_places_the_mesh(engine):
    topo = FakeTopology.pim_like((2, 2), devices=CPU * 4)
    placed = SpmvEngine(topology=topo)  # the topology's devices: the pool
    assert placed.devices == topo.flat_devices() and placed.n_devices == 4
    entry = placed.register("m", _mats()["regular"], warmup=False)
    mesh = placed.plan_for("m").mesh
    assert entry.plan.grid == tuple(mesh.devices.shape)
    if entry.plan.partitioning == "2d":  # laid out by an axis assignment
        assert sorted(mesh.slots.reshape(-1).tolist()) == [0, 1, 2, 3]
    x = np.arange(entry.shape[1], dtype=np.float32) % 5 - 2
    # random f32 values summed over 4 parts: the reference's tolerance
    np.testing.assert_allclose(placed.multiply("m", x), engine.multiply("m", x),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("call,item", [
    (_solve_agrees_with_jax, None),  # ported: works, no longer raises
    (_refine_works, None),  # ported with repro.tune
    (lambda e: SpmvEngine(devices=CPU, tune=True), None),
    (lambda e: SpmvEngine(devices=CPU, tuner=object()), None),
    (_topology_places_the_mesh, None),  # ported with repro.topo
], ids=["solve", "refine", "tune", "tuner", "topology"])
def test_not_ported_yet_raises_naming_its_roadmap_item(engine, call, item):
    engine.register("m", _mats()["regular"], warmup=False)
    if item is None:
        call(engine)
        return
    with pytest.raises(NotImplementedError, match=item):
        call(engine)


def test_cuda_without_a_card_raises_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, "cuda", ["cuda"] * 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpmvEngine(devices=devices)
    with pytest.raises(NotImplementedError, match="Multi-card") as e:
        SpmvEngine(devices=["cpu", "cuda:0"])
    assert "SpmvEngine(world=)" in str(e.value)  # the way to serve a pool


def test_engine_validation():
    with pytest.raises(ValueError, match="unknown impl"):
        SpmvEngine(devices=CPU, impl="pallas")
    eng = SpmvEngine(devices=CPU)
    with pytest.raises(ValueError, match="unknown impl"):
        eng.register("m", _mats()["regular"], impl="xla")


@pytest.mark.parametrize("bad", [dict(tune_margin=0.0), dict(tune_margin=1.5),
                                 dict(drift_factor=1.0),
                                 dict(drift_alpha=0.0)], ids=str)
def test_tuning_knobs_match_jax_signature(bad):
    """The JAX engine's tuning knobs are accepted with its defaults and
    validated as it validates them; tune=True is accepted with them."""
    eng, jeng = SpmvEngine(devices=CPU), JEngine(devices=jax.devices()[:1])
    for knob in ("tune_after", "tune_margin", "drift_factor", "drift_alpha"):
        assert getattr(eng, knob) == getattr(jeng, knob)
    eng = SpmvEngine(devices=CPU, tune_after=4, tune_margin=0.8,
                     drift_factor=None, drift_alpha=0.5)
    assert (eng.tune_after, eng.tune_margin, eng.drift_factor,
            eng.drift_alpha) == (4, 0.8, None, 0.5)
    with pytest.raises(ValueError) as want:
        JEngine(devices=jax.devices()[:1], **bad)
    with pytest.raises(ValueError) as got:
        SpmvEngine(devices=CPU, **bad)
    assert str(got.value) == str(want.value)
    eng = SpmvEngine(devices=CPU, tune=True, tune_after=2)
    assert eng.tune and eng.tune_after == 2 and eng.tune_events == []


def test_same_matrix_torch_and_cuda_are_separate_cache_entries(engine):
    a = matrices()["regular"]
    kt = engine.register("mt", a, impl="torch").cache_key
    kc = engine.register("mc", a, impl="cuda").cache_key
    assert kt != kc and kt[:-1] == kc[:-1]
    x = vectors()["x"]
    np.testing.assert_array_equal(engine.multiply("mt", x),
                                  engine.multiply("mc", x))


def test_telemetry_breakdown_fractions(engine):
    a = _mats()["regular"]
    engine.register("m", a)
    for _ in range(3):
        engine.multiply("m", np.zeros(a.shape[1], np.float32))
    bd = engine.telemetry.breakdown("m")
    assert (bd["requests"], bd["vectors"]) == (3, 3)
    assert abs(bd["load"] + bd["kernel"] + bd["retrieve"] - 1.0) < 1e-9
    assert bd["total_s"] > 0


# ------------------------------------------------------------------ batcher


class _Recorder:
    """Registry + multiply stand-in recording every batch it serves."""

    class _Entry:
        shape = (4, 6)

    class _Registry:
        def get(self, name):
            return _Recorder._Entry()

    def __init__(self):
        self.registry = self._Registry()
        self.batches = []

    def multiply(self, name, X, obs=None):
        self.batches.append((name, np.asarray(X).copy()))
        return np.zeros((4, np.asarray(X).shape[1]), np.float32)


SCRIPTS = {
    "fifo": [("m", k, None) for k in range(11)],
    "classes": [("m", k, 2) for k in range(5)] + [("m", 50, 0), ("m", 51, 1),
                                                   ("m", 52, 0)],
    "two-queues": [("a", k, k % 3) for k in range(6)]
                  + [("b", 10 + k, None) for k in range(3)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_batcher_formation_matches_jax(script):
    """Chunking, bucket padding and priority order, on both packages'
    batchers over a recording engine, explicit flush."""
    served = []
    for cls in (JMicroBatcher, MicroBatcher):
        rec = _Recorder()
        mb = cls(rec, max_batch=3, buckets=(1, 2, 4), auto_flush=False,
                 promote_after_s=60.0)
        futs = [mb.submit(n, np.full(6, float(v), np.float32), priority=p)
                for n, v, p in SCRIPTS[script]]
        assert mb.pending() == len(futs)
        mb.flush()
        assert all(f.done() for f in futs)
        served.append(([(n, X.tolist()) for n, X in rec.batches],
                       mb.batches_run, mb.vectors_run, mb.preemptions))
    assert served[1] == served[0]


def test_batcher_coalesces_pads_and_answers(engine):
    a = matrices()["scale-free"]
    engine.register("m", a)
    mb = MicroBatcher(engine, max_batch=4, buckets=(1, 2, 4))
    vecs = vectors()["X"].T
    futs = [mb.submit("m", v) for v in vecs[:3]]
    assert mb.pending("m") == 3 and mb.batches_run == 0
    assert mb.flush() == 3
    assert engine.telemetry.records[-1].batch == 4  # 3 padded to bucket 4
    futs.append(mb.submit("m", vecs[3]))
    futs += [mb.submit("m", v) for v in vecs[:3]]  # 4th pending: auto-flush
    assert mb.batches_run == 2 and mb.pending("m") == 0
    assert engine.telemetry.records[-1].batch == 4
    for f, v in zip(futs, list(vecs) + list(vecs[:3])):
        np.testing.assert_array_equal(f.result(timeout=TIMEOUT), a @ v)


def test_batcher_rejects_wrong_length_vector(engine):
    engine.register("m", _mats()["regular"])
    mb = MicroBatcher(engine, max_batch=4, buckets=(4,), auto_flush=False)
    with pytest.raises(ValueError, match="cols"):
        mb.submit("m", np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="single vector"):
        mb.submit("m", np.zeros((128, 2), np.float32))


def test_batcher_survives_cancelled_future_and_delivers_failures(engine):
    a = matrices()["regular"]
    engine.register("m", a)
    mb = MicroBatcher(engine, max_batch=8, buckets=(8,), auto_flush=False)
    f1 = mb.submit("m", np.zeros(128, np.float32))
    x = vectors()["x"]
    f2 = mb.submit("m", x)
    assert f1.cancel()
    mb.flush()
    np.testing.assert_array_equal(f2.result(timeout=TIMEOUT), a @ x)
    fut = mb.submit("m", x)
    engine.cache.clear()  # evicted under the batcher
    mb.flush()
    with pytest.raises(RuntimeError, match="evicted"):
        fut.result(timeout=TIMEOUT)


def test_batcher_deadline_flush_in_background(engine):
    a = matrices()["regular"]
    engine.register("m", a)
    mb = MicroBatcher(engine, max_batch=8, buckets=(8,), max_delay_s=0.02)
    vecs = vectors()["X"].T
    mb.start()
    try:
        futs = [mb.submit("m", v) for v in vecs[:3]]
        for f, v in zip(futs, vecs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), a @ v)
        # an urgent submit pulls the flush forward past a 30 s default
        slow = mb.submit("m", vecs[3], deadline_s=30.0)
        fast = mb.submit("m", vecs[0], deadline_s=0.01)
        np.testing.assert_array_equal(fast.result(timeout=TIMEOUT), a @ vecs[0])
        assert slow.done()
    finally:
        mb.stop()
    assert mb.deadline_flushes >= 2 and mb.vectors_run == 5
    assert mb._thread is None  # stop() joined the flush thread


def test_batcher_stop_without_drain_cancels_pending(engine):
    engine.register("m", _mats()["regular"])
    mb = MicroBatcher(engine, max_batch=8, buckets=(8,), max_delay_s=30.0)
    mb.start()
    try:
        fut = mb.submit("m", np.zeros(128, np.float32))
    finally:
        mb.stop(drain=False)
    assert fut.cancelled()


# ---------------------------------------------------------------- counters


def test_launch_counter_counts_every_launch_from_8_threads():
    """The serving path launches from several host threads at once: no
    count may be lost (a short switch interval makes a lost update likely
    without the lock)."""
    instrument.reset()
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=TIMEOUT)
        for _ in range(20000):
            instrument.record_launch("coo", batch=4)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert instrument.launches("coo") == instrument.launches("coo.spmm") == 160000
    instrument.reset()
    assert instrument.launches() == 0
