"""repro_torch's solver sessions against repro's, on the same seeded inputs.

``Executor.iterate`` (``repro_torch.api.iterate``), ``SpmvEngine.solve``,
``AsyncSpmvService.solve`` and solver sessions in a replay, held against
the JAX package on the CPU: the JAX side runs ``impl="xla"`` and
``impl="pallas"`` (interpret mode), the port ``device="cpu"`` with
``impl="torch"`` and ``impl="cuda"`` (the kernels' plain versions).

  * steps mode, linear combines: bit-identical to the JAX package and to k
    host-side ``exe(x)`` calls — plain on integer-valued inputs (every sum
    exact), Richardson and Jacobi on dyadic ones;
  * power and a callable combine within 1e-5 of the JAX package (the
    reference's tolerance), power within 1e-4 of a float64 power loop;
  * tol mode: the pinned counts of tests/test_solver.py (CG 11, PageRank
    12, ``max_steps=17`` not converged), the same as the JAX package's;
  * every bad call raises the exception type the JAX package raises;
  * the engine (one ``kind="solve"`` record per session, an evicted plan
    reactivated, ``requests += steps``), the service (one admission per
    session, deadline shedding on the per-iteration EWMA, x0 shape
    errors) and a ``solve_frac=0.3`` replay against the JAX replay of the
    same trace.

The 4-part mesh cases run in tests/test_torch_mesh.py's subprocess.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _solver_runner as sr
import repro.serve as jserve
import repro_torch.serve as tserve
from repro.api import SparseMatrix as JSparseMatrix
from repro.engine import SpmvEngine as JEngine
from repro_torch.api import COMBINES, IterateResult, SparseMatrix, make_combine
from repro_torch.engine import SpmvEngine
from repro_torch.serve import RequestRejected, WorkloadSpec, generate_trace

TO_JAX = {"torch": "xla", "cuda": "pallas"}
FMTS = ["coo", "csr", "bcoo", "bcsr"]
TIMEOUT = 60  # seconds any service coroutine is waited for


def int_square(n: int, seed: int, per_row: int = 3) -> np.ndarray:
    """n x n, ``per_row`` entries in {-2, -1, 1, 2} per row: row sums of
    |a| stay <= 6, so 5 plain steps from x0 in {-2..2} stay below 2^24 and
    every float32 sum is exact."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, rng.choice(n, per_row, replace=False)] = rng.choice(
            [-2, -1, 1, 2], per_row)
    return a


def port_exe(a, impl="torch", **kw):
    return SparseMatrix.from_dense(a).plan(impl=impl, device="cpu",
                                           **kw).compile()


def jax_exe(a, impl="xla", **kw):
    return JSparseMatrix.from_dense(a).plan(impl=impl, **kw).compile()


def _serve(svc, body, timeout=TIMEOUT):
    """``await body(svc)`` on the started service, bounded; the service is
    closed and its flush thread stopped whatever happens."""

    async def main():
        svc.start()
        try:
            return await asyncio.wait_for(body(svc), timeout)
        finally:
            try:
                await asyncio.wait_for(svc.aclose(), timeout)
            finally:
                svc.batcher.stop(drain=False)

    return asyncio.run(main())


# ------------------------------------------------ steps mode: bit parity


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_plain_steps_bit_identical_to_jax_and_host_loop(fmt, impl):
    a = int_square(48, seed=11)
    x0 = np.random.default_rng(1).integers(-2, 3, 48).astype(np.float32)
    exe = port_exe(a, impl, fmt=fmt)
    res = exe.iterate(x0, steps=5, combine="plain")
    assert isinstance(res, IterateResult) and res.steps == 5 and res.compiled
    want = jax_exe(a, TO_JAX[impl], fmt=fmt).iterate(x0, steps=5,
                                                    combine="plain")
    assert res.x.dtype == np.float32
    np.testing.assert_array_equal(res.x, np.asarray(want.x))
    np.testing.assert_array_equal(res.x, sr.host_loop(exe, x0, 5, "plain"))
    np.testing.assert_array_equal(res.x, np.linalg.matrix_power(
        a.astype(np.float64), 5) @ x0)
    assert res.residual == pytest.approx(want.residual, rel=1e-6)
    assert not exe.iterate(x0, steps=5).compiled  # the loop is cached


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_steps_equal_host_loop_on_random_floats(seed):
    """Random float32: the same kernel program runs in both loops, so the
    session equals k host calls bit for bit (cross-package sums differ)."""
    a = sr.random_square(56, 0.2, seed=0, spectral_radius=1.1)
    exe = port_exe(a, "cuda", fmt="coo")
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(56).astype(np.float32)
    k = int(rng.integers(1, 8))
    res = exe.iterate(x0, steps=k, combine="plain")
    np.testing.assert_array_equal(res.x, sr.host_loop(exe, x0, k, "plain"))


@pytest.mark.parametrize("combine", ["richardson", "jacobi"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_linear_combines_bit_identical_dyadic(combine, impl):
    """Dyadic values (integer entries, omega 1/4, a diagonal of 4): every
    intermediate is exact, so the session, the JAX session and the host
    loop agree bit for bit whatever order each kernel sums in."""
    rng = np.random.default_rng(7)
    off = (rng.random((48, 48)) < 0.12) * rng.integers(-2, 3, (48, 48))
    np.fill_diagonal(off, 0)
    a = (off + 4 * np.eye(48)).astype(np.float32)
    diag = np.diag(a).astype(np.float32)
    x0 = rng.integers(-3, 4, 48).astype(np.float32)
    b = rng.integers(-3, 4, 48).astype(np.float32)
    kw = dict(b=b, omega=0.25) if combine == "richardson" else \
        dict(b=b, diag=diag)
    exe = port_exe(a, impl, fmt="csr")
    res = exe.iterate(x0, steps=5, combine=combine, **kw)
    want = jax_exe(a, TO_JAX[impl], fmt="csr").iterate(
        x0, steps=5, combine=combine, **kw)
    np.testing.assert_array_equal(res.x, np.asarray(want.x))
    np.testing.assert_array_equal(res.x, sr.host_loop(exe, x0, 5, combine,
                                                      **kw))
    assert res.residual == pytest.approx(want.residual, rel=1e-6)


def test_power_and_callable_within_reference_tolerance():
    a = sr.random_square(40, 0.25, seed=9, spectral_radius=2.0)
    x0 = np.random.default_rng(2).standard_normal(40).astype(np.float32)
    exe, jexe = port_exe(a, "cuda", fmt="coo"), jax_exe(a, fmt="coo")
    res = exe.iterate(x0, steps=20, combine="power")
    np.testing.assert_allclose(res.x, np.asarray(jexe.iterate(
        x0, steps=20, combine="power").x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.x.astype(np.float64),
                               sr.np_power(a, x0, 20), atol=1e-4)
    res = exe.iterate(x0, steps=4, combine=lambda x, y: 0.5 * (x + y))
    want = jexe.iterate(x0, steps=4, combine=lambda x, y: 0.5 * (x + y))
    np.testing.assert_allclose(res.x, np.asarray(want.x), rtol=1e-5, atol=1e-5)
    assert res.steps == 4 and res.compiled


def test_float64_and_bfloat16_iterate():
    """float64 stays in the torch oracles (JAX without x64 has none) and
    iterates bit-identically to its host loop; a bfloat16 matrix under
    impl="cuda" feeds each float32 result back cast to bfloat16, as the
    host loop's ``_check_x`` does."""
    a = sr.random_square(32, 0.2, seed=4, spectral_radius=1.1).astype(
        np.float64)
    x0 = np.random.default_rng(5).standard_normal(32)
    exe = port_exe(a, "torch", fmt="coo")
    res = exe.iterate(x0, steps=3, combine="plain")
    assert res.x.dtype == np.float64
    np.testing.assert_array_equal(res.x, exe(exe(exe(x0))))
    ab = torch.from_numpy(int_square(32, seed=3)).to(torch.bfloat16)
    exe = SparseMatrix.from_dense(ab).plan(impl="cuda", device="cpu").compile()
    xb = torch.from_numpy(np.random.default_rng(6).integers(
        -2, 3, 32).astype(np.float32)).to(torch.bfloat16)
    res = exe.iterate(xb, steps=2)
    y = exe(exe(xb))  # float32 host rows
    assert y.dtype == np.float32
    np.testing.assert_array_equal(
        torch.from_numpy(np.asarray(res.x, np.float32)),
        torch.from_numpy(y).to(torch.bfloat16).float())


# ------------------------------------------------ tol mode: pinned counts


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_cg_laplacian_pinned_iteration_count(impl):
    n = 64
    a = sr.spd_laplacian(n)
    b = np.random.default_rng(1).integers(-2, 3, n).astype(np.float32)
    kw = dict(tol=1e-5, combine="cg", b=b, max_steps=200, check_every=1)
    res = port_exe(a, impl, fmt="csr").iterate(np.zeros(n, np.float32), **kw)
    want = jax_exe(a, fmt="csr").iterate(np.zeros(n, np.float32), **kw)
    x_ref, iters_ref = sr.np_cg(a, b, np.zeros(n), 1e-5)
    assert res.converged and res.residual <= 1e-5
    assert res.steps == want.steps == iters_ref == 11
    np.testing.assert_allclose(res.x.astype(np.float64), x_ref, atol=1e-4)
    np.testing.assert_allclose(res.x, np.asarray(want.x), atol=1e-4)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_pagerank_power_pinned_iteration_count(impl):
    g = sr.pagerank_matrix(32, seed=5)
    x0 = np.full(32, 1.0 / 32, np.float32)
    kw = dict(tol=1e-6, combine="power", max_steps=100, check_every=4)
    res = port_exe(g, impl, fmt="coo").iterate(x0, **kw)
    want = jax_exe(g, fmt="coo").iterate(x0, **kw)
    assert res.converged and res.residual <= 1e-6
    assert res.steps == want.steps == 12 and res.steps % 4 == 0
    ref = sr.np_power(g, np.full(32, 1.0 / 32), 100)
    pr = res.x.astype(np.float64)
    np.testing.assert_allclose(pr / pr.sum(), ref / ref.sum(), atol=1e-5)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_tol_never_reached_stops_at_max_steps(impl):
    a = (-np.eye(24)).astype(np.float32)
    x0 = np.random.default_rng(0).standard_normal(24).astype(np.float32)
    kw = dict(tol=1e-9, combine="power", max_steps=17, check_every=5)
    res = port_exe(a, impl, fmt="coo").iterate(x0, **kw)
    want = jax_exe(a, fmt="coo").iterate(x0, **kw)
    assert not res.converged and not want.converged
    assert res.steps == want.steps == 17 and res.residual > 1e-9


def test_tol_mode_reads_the_residual_once_per_chunk(monkeypatch):
    """The loop tests ``k < max_steps and res > tol`` before each chunk:
    one host read of the residual per test, none inside a chunk."""
    from repro_torch.api import iterate as it

    reads = []
    inner = it.PowerCombine.residual
    monkeypatch.setattr(it.PowerCombine, "residual",
                        lambda self, c: reads.append(1) or inner(self, c))
    a = (-np.eye(24)).astype(np.float32)
    x0 = np.ones(24, np.float32)
    res = port_exe(a).iterate(x0, tol=1e-9, combine="power", max_steps=17,
                              check_every=5)
    # tests at k = 0, 5, 10, 15 read; k = 17 stops on max_steps; +1 retrieve
    assert res.steps == 17 and len(reads) == 4 + 1


# ------------------------------------------------------- failure paths

BAD_CALLS = {
    "neither": lambda e, x0: e.iterate(x0),
    "both": lambda e, x0: e.iterate(x0, steps=3, tol=1e-6),
    "batched": lambda e, x0: e.iterate(np.zeros((16, 2), np.float32), steps=3),
    "unknown-combine": lambda e, x0: e.iterate(x0, steps=3,
                                               combine="not-a-combine"),
    "cg-without-b": lambda e, x0: e.iterate(x0, steps=3, combine="cg"),
    "jacobi-without-diag": lambda e, x0: e.iterate(
        x0, steps=3, combine="jacobi", b=np.ones(16, np.float32)),
    "zero-diagonal": lambda e, x0: e.iterate(
        x0, steps=3, combine="jacobi", b=np.ones(16, np.float32),
        diag=np.zeros(16, np.float32)),
    "steps-zero": lambda e, x0: e.iterate(x0, steps=0),
    "bad-b-shape": lambda e, x0: e.iterate(x0, steps=3, combine="richardson",
                                           b=np.ones(15, np.float32)),
}


def _raised(call, exe, x0):
    try:
        call(exe, x0)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_bad_calls_raise_as_jax_does(case):
    a = sr.spd_laplacian(16)
    x0 = np.zeros(16, np.float32)
    want = _raised(BAD_CALLS[case], jax_exe(a, fmt="coo"), x0)
    assert want is not None
    with pytest.raises(want):
        BAD_CALLS[case](port_exe(a, fmt="coo"), x0)


def test_non_square_and_released_executors_raise():
    rect = sr.random_square(16, 0.3, seed=0)[:8, :]
    with pytest.raises(ValueError, match="square"):
        jax_exe(rect, fmt="coo").iterate(np.zeros(16, np.float32), steps=2)
    for kw in (dict(fmt="coo", device="cpu"),
               dict(scheme="1d", devices=["cpu"] * 4)):
        exe = SparseMatrix.from_dense(rect).plan(**kw).compile()
        with pytest.raises(ValueError, match="square"):
            exe.iterate(np.zeros(16, np.float32), steps=2)
    exe = port_exe(sr.spd_laplacian(16), "cuda", fmt="coo")
    exe.release()
    with pytest.raises(RuntimeError, match="released"):
        exe.iterate(np.zeros(16, np.float32), steps=2)
    assert set(COMBINES) == {"plain", "power", "richardson", "jacobi", "cg"}
    assert make_combine(lambda x, y: y).name == "callable"


# ------------------------------------------------------------- engine


def _engines(a, cache_capacity=4):
    eng = SpmvEngine(devices=["cpu"], cache_capacity=cache_capacity)
    jeng = JEngine(devices=jax.devices()[:1], cache_capacity=cache_capacity)
    return eng, jeng


def test_engine_solve_records_one_session_and_matches_jax():
    a = int_square(32, seed=6)
    eng, jeng = _engines(a)
    x0 = np.random.default_rng(0).integers(-2, 3, 32).astype(np.float32)
    for e in (eng, jeng):
        e.register("m", a)
        e.multiply("m", x0)
    res = eng.solve("m", x0, steps=5, combine="plain")
    want = jeng.solve("m", x0, steps=5, combine="plain")
    np.testing.assert_array_equal(res.x, np.asarray(want.x))
    recs = [r for r in eng.telemetry.records if r.kind == "solve"]
    assert len(recs) == 1 and recs[0].steps == 5 and recs[0].traced
    assert eng.telemetry.last("m").kind == "multiply"
    assert eng.telemetry.last_solve("m").steps == 5
    assert eng.registry.get("m").requests == 1 + 5  # steps, not sessions
    eng.solve("m", x0, steps=5, combine="plain")
    assert not eng.telemetry.last_solve("m").traced
    bd = eng.telemetry.breakdown("m")
    assert bd["solves"] == 2 and bd["solve_steps"] == 10


def test_engine_solve_on_evicted_plan_reactivates():
    a1 = sr.random_square(32, 0.2, seed=1, spectral_radius=1.0)
    a2 = sr.random_square(32, 0.2, seed=2, spectral_radius=1.0)
    eng, jeng = _engines(None, cache_capacity=1)
    for e in (eng, jeng):
        e.register("one", a1)
        e.register("two", a2)  # evicts "one" from the plan cache
    assert eng.plan_for("one") is None
    parts = eng.partition_count
    x0 = np.random.default_rng(3).standard_normal(32).astype(np.float32)
    res = eng.solve("one", x0, steps=6, combine="power")
    assert eng.partition_count == parts  # rebuilt from the spilled partition
    np.testing.assert_allclose(res.x.astype(np.float64),
                               sr.np_power(a1, x0, 6), atol=1e-4)
    np.testing.assert_allclose(res.x, np.asarray(jeng.solve(
        "one", x0, steps=6, combine="power").x), rtol=1e-5, atol=1e-5)
    assert eng.registry.get("one").requests == 6


def test_engine_solve_obs_spans_and_tol_mode():
    from repro_torch.obs import Tracer

    g = sr.pagerank_matrix(32, seed=5)
    eng = SpmvEngine(devices=["cpu"] * 4)  # a 4-part plan on the CPU
    eng.register("g", g)
    tracer = Tracer()
    res = eng.solve("g", np.full(32, 1.0 / 32, np.float32), tol=1e-6,
                    combine="power", max_steps=100, check_every=4,
                    obs=tracer.trace("t/g:solve"))
    assert res.converged and res.steps == 12
    spans = {s.name: s for s in tracer.spans()}
    assert set(spans) == {"load", "kernel", "retrieve"}
    assert spans["kernel"].args["steps"] == 12


# ------------------------------------------------------------- service


def _solver_service(pkg=tserve, **kwargs):
    a = sr.random_square(48, 0.2, seed=3, spectral_radius=2.0)
    if pkg is tserve:
        engine = SpmvEngine(devices=["cpu"], cache_capacity=8)
    else:
        engine = JEngine(devices=jax.devices()[:1], cache_capacity=8)
    svc = pkg.AsyncSpmvService(engine, **kwargs)
    svc.register(None, "graph", a)
    return svc, a


def test_service_solve_matches_reference_and_charges_once():
    svc, a = _solver_service()
    admits = []
    inner = svc.admission.admit
    svc.admission.admit = lambda *aa, **kw: (admits.append(kw),
                                             inner(*aa, **kw))[1]
    x0 = np.random.default_rng(0).standard_normal(48).astype(np.float32)

    async def body(svc):
        return await svc.solve("tenant-a", "graph", x0, steps=16,
                               combine="power")

    res = _serve(svc, body)
    jres = _serve(_solver_service(jserve)[0], body)
    np.testing.assert_allclose(res.x.astype(np.float64),
                               sr.np_power(a, x0, 16), atol=1e-4)
    np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-5,
                               atol=1e-5)
    assert res.steps == 16 and len(admits) == 1 and admits[0]["vectors"] == 1
    assert svc.admission.state("tenant-a").pending == 0
    assert svc.served == 1 and svc.errors == 0
    snap = svc.metrics.snapshot()
    assert snap["serve.solve.per_iter_us"]["count"] == 1
    assert snap["serve.solve.e2e_ms{cls=standard}"]["count"] == 1


def test_service_solve_deadline_sheds_on_per_iter_ewma():
    svc, _ = _solver_service()
    x0 = np.random.default_rng(1).standard_normal(48).astype(np.float32)

    async def body(svc):
        # the first session builds its loop (skipped as an outlier), the
        # second populates the per-iteration EWMA
        for _ in range(2):
            await svc.solve("tenant-a", "graph", x0, steps=8, combine="power")
        assert svc._solve_est.get("graph", 0.0) > 0.0
        with pytest.raises(RequestRejected) as exc:
            await svc.solve("tenant-a", "graph", x0, steps=1_000_000,
                            combine="power", deadline_s=1e-7)
        assert exc.value.reason == "deadline_infeasible"
        assert svc.admission.state("tenant-a").pending == 0
        return await svc.solve("tenant-a", "graph", x0, steps=4,
                               combine="power")

    assert _serve(svc, body).steps == 4
    assert svc.estimate(None, "graph") is None  # sessions feed their own EWMA


@pytest.mark.parametrize("shape", [(48, 2), (47,)])
def test_service_solve_validates_x0_shape(shape):
    svc, _ = _solver_service()

    async def body(svc):
        with pytest.raises(ValueError, match="x0 must be"):
            await svc.solve("tenant-a", "graph", np.zeros(shape, np.float32),
                            steps=2)

    _serve(svc, body)
    assert svc.admission.state("tenant-a").pending == 0


# -------------------------------------------------------------- replay


def test_replay_with_solver_sessions_matches_jax():
    rng = np.random.default_rng(0)
    a = np.round(rng.standard_normal((48, 48)) * 2.0).astype(np.float32)
    a[np.abs(a) < 1] = 0.0
    spec = dict(names=("g",), n_requests=24, seed=7, solve_frac=0.3,
                solve_steps=6, integer_values=True, rate_rps=2000.0)
    trace = generate_trace(WorkloadSpec(**spec))
    assert [dataclasses.astuple(r) for r in trace] == [
        dataclasses.astuple(r)
        for r in jserve.generate_trace(jserve.WorkloadSpec(**spec))]
    n_solves = sum(r.is_solve for r in trace)
    assert n_solves > 0
    reports = []
    for pkg, engine in ((tserve, SpmvEngine(devices=["cpu"])),
                        (jserve, JEngine(devices=jax.devices()[:1]))):
        svc = pkg.AsyncSpmvService(engine)
        svc.register(None, "g", a)
        reports.append(_serve(svc, lambda s, pkg=pkg: pkg.replay(
            s, trace, oracles={"g": a}, time_scale=0.0, integer_values=True)))
    rep, want = reports
    assert rep.lost == 0 and rep.errors == 0 and rep.completed == len(trace)
    assert rep.solves == want.solves == n_solves
    assert rep.solves_converged == 0  # steps-mode sessions: tol N/A
    assert rep.solve_iters == want.solve_iters
    assert rep.solve_iters["mean"] == pytest.approx(6.0)
    assert rep.solve_per_iter_us > 0.0 and rep.solve_latency["p50_ms"] > 0.0
    assert rep.verified == want.verified == len(trace)  # sessions included
    assert rep.max_abs_err <= 1e-4
    assert rep.to_dict()["solves"] == n_solves


def test_replay_power_sessions_against_tensor_oracles():
    rng = np.random.default_rng(1)
    a = np.round(rng.standard_normal((48, 48)) * 2.0).astype(np.float32)
    a[np.abs(a) < 1] = 0.0
    trace = generate_trace(WorkloadSpec(names=("g",), n_requests=16, seed=3,
                                        solve_frac=0.5, solve_steps=4,
                                        integer_values=True))
    svc = tserve.AsyncSpmvService(SpmvEngine(devices=["cpu"]))
    svc.register(None, "g", a)
    rep = _serve(svc, lambda s: tserve.replay(
        s, trace, oracles={"g": torch.from_numpy(a)}, time_scale=0.0,
        integer_values=True))
    assert rep.solves == sum(r.is_solve for r in trace) > 0
    assert rep.verified == rep.completed == len(trace)
    assert rep.max_abs_err <= 1e-4
