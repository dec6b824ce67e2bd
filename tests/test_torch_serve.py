"""repro_torch.serve against repro.serve, on the same seeded inputs.

Traces and payloads (``generate_trace`` / ``request_vector``) must be
bit-identical to the JAX package's for equal specs; token buckets and the
admission controller must take the same decisions under an injected clock;
``AsyncSpmvService`` over the port's engine (4 parts or one, on the CPU)
must answer as the JAX service does, bit for bit on integer values; and a
replay at ``time_scale=0`` with dense oracles must lose nothing, shed every
infeasible request and match the oracle bit for bit.

Every service runs through :func:`_serve`: its waits are bounded by
``asyncio.wait_for`` and its flush thread is stopped in a ``finally``, so a
hang fails one test instead of the whole run.
"""
import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro.api import SparseMatrix as JSparseMatrix
from repro.engine import SpmvEngine as JEngine
from repro_torch.engine import SpmvEngine
from repro_torch.serve import (AsyncSpmvService, RequestRejected, TenantConfig,
                               WorkloadSpec, generate_trace, replay)

from _torch_engine_cases import matrices

TIMEOUT = 60  # seconds any service coroutine is waited for
NAMES = ("regular", "scale-free")


def _serve(svc, body, timeout=TIMEOUT):
    """Run ``await body(svc)`` on the started service; bounded, and the
    service closed and its flush thread stopped whatever happens."""

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


def _service(pkg=tserve, parts=1, **kwargs):
    """A service over integer-valued matrices, registered globally."""
    if pkg is tserve:
        engine = SpmvEngine(devices=["cpu"] * parts, cache_capacity=8)
    else:
        engine = JEngine(devices=jax.devices()[:1], cache_capacity=8)
    svc = pkg.AsyncSpmvService(engine, **kwargs)
    for name in NAMES:
        svc.register(None, name, matrices()[name])
    return svc


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


# ------------------------------------------------------------- workload

SPECS = {
    "poisson": dict(),
    "bursty": dict(arrivals="bursty", rate_rps=300.0),
    "classes": dict(tenants=("a", "b", "c"),
                    tenant_classes={"a": "rt", "b": "standard", "c": "batch"}),
    "infeasible": dict(deadline_s=1.0, infeasible_frac=0.05,
                       integer_values=True, arrivals="bursty"),
    "mix": dict(batch_mix={1: 0.5, 2: 0.2, 8: 0.3}, zipf_alpha=0.0),
    "solve": dict(solve_frac=0.2, solve_steps=5),
}


def _spec(pkg, case):
    base = dict(names=("regular", "scale-free", "block"), tenants=("a", "b"),
                n_requests=80, seed=9, rate_rps=1000.0)
    base.update(SPECS[case])
    return pkg.WorkloadSpec(**base)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_trace_and_payloads_match_jax(case):
    jt = jserve.generate_trace(_spec(jserve, case))
    tt = tserve.generate_trace(_spec(tserve, case))
    assert [dataclasses.astuple(r) for r in tt] == \
        [dataclasses.astuple(r) for r in jt]
    assert tserve.describe_trace(tt) == jserve.describe_trace(jt)
    assert tserve.popularity(_spec(tserve, case)) == \
        jserve.popularity(_spec(jserve, case))
    configs = [{k: dataclasses.astuple(v) for k, v in
                pkg.tenant_configs(_spec(pkg, case), max_pending=9).items()}
               for pkg in (jserve, tserve)]
    assert configs[1] == configs[0]
    for jr, tr in list(zip(jt, tt))[:12]:
        for integer in (False, True):
            for dtype in (np.float32, np.int32):
                kw = dict(dtype=dtype, integer=integer)
                got = tserve.request_vector(tr, 37, **kw)
                want = jserve.request_vector(jr, 37, **kw)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(names=()), dict(tenants=()), dict(arrivals="fractal"),
    dict(rate_rps=0.0), dict(infeasible_frac=1.5), dict(batch_mix={}),
    dict(solve_steps=0), dict(tenant_classes={"ghost": "rt"}),
    dict(tenant_classes={"a": "premium"}),
])
def test_workload_validation_matches_jax(bad):
    for pkg in (jserve, tserve):
        kw = dict(names=("m",), tenants=("a",))
        kw.update(bad)
        with pytest.raises(ValueError):
            pkg.WorkloadSpec(**kw)


# ------------------------------------------------------------ admission


def test_slo_constants_match_jax():
    for name in ("SLO_CLASSES", "REJECT_REASONS", "CLASS_RATE_WEIGHTS",
                 "CLASS_DEADLINE_DEFAULTS"):
        assert getattr(tserve, name) == getattr(jserve, name), name
    for cls in tserve.SLO_CLASSES:
        assert tserve.class_rank(cls) == jserve.class_rank(cls)
        assert tserve.class_rate_weight(cls) == jserve.class_rate_weight(cls)
        assert tserve.default_deadline(cls) == jserve.default_deadline(cls)
    with pytest.raises(ValueError, match="unknown SLO class"):
        tserve.class_rank("premium")


def test_token_bucket_matches_jax():
    rng = np.random.default_rng(4)
    script = [(float(n), float(t)) for n, t in
              zip(rng.integers(1, 5, 60), np.cumsum(rng.exponential(0.05, 60)))]
    outs = []
    for pkg in (jserve, tserve):
        tb = pkg.TokenBucket(rate=10.0, burst=6)
        outs.append([(tb.try_take(n, now=t), tb.tokens) for n, t in script])
    assert outs[1] == outs[0]
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError):
            pkg.TokenBucket(rate=0.0)
        with pytest.raises(ValueError):
            pkg.TokenBucket(rate=1.0, burst=0.5)


ADMISSION_TENANTS = {
    "rt": dict(priority="rt", rate_rps=20.0, burst=4, max_pending=3),
    "std": dict(max_pending=2),
    "bulk": dict(priority="batch", rate_rps=5.0, burst=8),
}


def _admission_script(seed):
    """A seeded list of (op, tenant, kwargs) admission calls."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(120):
        t += float(rng.exponential(0.03))
        tenant = str(rng.choice(list(ADMISSION_TENANTS) + ["open"]))
        if rng.random() < 0.35:
            out.append(("finished", tenant, {}))
            continue
        deadline = (None, 0.0, 0.01, 0.2, 5.0)[int(rng.integers(5))]
        estimate = (None, 0.001, 0.05)[int(rng.integers(3))]
        out.append(("admit", tenant, dict(
            vectors=int(rng.choice([1, 4, 8])), deadline_s=deadline,
            estimate_s=estimate, queue_depth=int(rng.integers(0, 6)), now=t)))
    return out


@pytest.mark.parametrize("seed,safety", [(0, 1.0), (1, 2.5), (2, 0.5)])
def test_admission_decisions_match_jax(seed, safety):
    outcomes = []
    for pkg in (jserve, tserve):
        metrics = (jobs if pkg is jserve else tobs).MetricsRegistry()
        ac = pkg.AdmissionController(safety=safety, metrics=metrics)
        for tenant, cfg in ADMISSION_TENANTS.items():
            ac.configure(tenant, pkg.TenantConfig(**cfg))
        got = []
        for op, tenant, kw in _admission_script(seed):
            if op == "finished":
                ac.finished(tenant)
                continue
            try:
                state = ac.admit(tenant, **kw)
                got.append(("admitted", state.pending))
            except pkg.RequestRejected as rej:
                got.append((rej.reason, str(rej)))
        ac.reject_all("std", "shutdown")
        outcomes.append((got, ac.snapshot(), metrics.snapshot()))
    assert outcomes[1] == outcomes[0]
    reasons = {r for r, _ in outcomes[1][0]}  # the script reaches several
    assert "admitted" in reasons and len(reasons - {"admitted"}) >= 2


def test_admission_validation():
    with pytest.raises(ValueError):
        tserve.AdmissionController(safety=0.0)
    with pytest.raises(ValueError, match="unknown SLO class"):
        TenantConfig(priority="premium")
    with pytest.raises(ValueError):
        AsyncSpmvService(SpmvEngine(devices=["cpu"]), est_alpha=0.0)


# -------------------------------------------------------------- service


def test_roundtrip_matches_jax_service():
    rng = np.random.default_rng(0)
    x, X = _ints(rng, 128), _ints(rng, (128, 4))

    async def body(svc):
        y = await svc.multiply("t1", "regular", x)
        Y = await svc.multiply("t2", "scale-free", X)  # explicit batch
        return y, Y

    want = _serve(_service(jserve), body)
    for parts in (1, 4):
        svc = _service(parts=parts)
        got = _serve(svc, body)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
        assert svc.served == 2 and svc.errors == 0


def test_concurrent_awaits_coalesce_into_spmm():
    a = matrices()["regular"]
    svc = _service(max_batch=8, buckets=(1, 2, 4, 8))
    vecs = [_ints(np.random.default_rng(k), 128) for k in range(6)]

    async def body(svc):
        return await asyncio.gather(*[svc.multiply("t", "regular", v)
                                      for v in vecs])

    for y, v in zip(_serve(svc, body), vecs):
        np.testing.assert_array_equal(y, a @ v)
    assert svc.batcher.vectors_run == 6 and svc.batcher.batches_run < 6
    widths = {r.batch for r in svc.engine.telemetry.records[1:]}
    assert widths <= {1, 2, 4, 8}


def test_three_classes_are_served_and_reported():
    mats = matrices()
    tenants = {"fast": TenantConfig(priority="rt"),
               "mid": TenantConfig(priority="standard"),
               "bulk": TenantConfig(priority="batch")}
    svc = _service(tenants=tenants)
    rng = np.random.default_rng(3)
    reqs = [(t, n, _ints(rng, 128)) for t in tenants for n in NAMES
            for _ in range(4)]

    async def body(svc):
        return await asyncio.gather(*[svc.multiply(t, n, x)
                                      for t, n, x in reqs])

    for y, (_, n, x) in zip(_serve(svc, body), reqs):
        np.testing.assert_array_equal(y, mats[n] @ x)
    snap = svc.stats()["tenants"]
    assert {t: snap[t]["priority"] for t in tenants} == \
        {"fast": "rt", "mid": "standard", "bulk": "batch"}
    assert all(snap[t]["completed"] == 8 for t in tenants)


def test_tenant_scoped_registration_resolves_before_global():
    mats = matrices()
    svc = _service()
    scaled = mats["regular"] * 2.0
    svc.register("t1", "regular", scaled)
    x = np.ones(128, np.float32)

    async def body(svc):
        return (await svc.multiply("t1", "regular", x),
                await svc.multiply("t2", "regular", x))

    y1, y2 = _serve(svc, body)
    np.testing.assert_array_equal(y1, scaled @ x)
    np.testing.assert_array_equal(y2, mats["regular"] @ x)


def test_errors_sheds_and_shutdown():
    svc = _service()
    x = np.zeros(128, np.float32)

    async def body(svc):
        with pytest.raises(KeyError, match="neither"):
            await svc.multiply("t", "nope", x)
        with pytest.raises(ValueError, match="cols"):
            await svc.multiply("t", "regular", np.zeros(7, np.float32))
        with pytest.raises(RequestRejected) as exc:
            await svc.multiply("t", "regular", x, deadline_s=0.0)
        assert exc.value.reason == "deadline_infeasible"
        for _ in range(3):  # warm the service-time estimate
            await svc.multiply("t", "regular", x)
        est = svc.estimate(None, "regular")
        assert est is not None and 0 < est < 0.5
        with pytest.raises(RequestRejected) as exc:
            await svc.multiply("t", "regular", x, deadline_s=est * 1e-6)
        assert exc.value.reason == "deadline_infeasible"
        # solve is ported: a square matrix's session equals the JAX
        # package's; a non-square one raises ValueError, as there
        sq = matrices()["regular"][:, :96]
        svc.register(None, "square", sq)
        x0 = np.random.default_rng(5).integers(-3, 4, 96).astype(np.float32)
        res = await svc.solve("t", "square", x0, steps=3)
        want = JSparseMatrix.from_dense(sq).plan().compile().iterate(
            x0, steps=3)
        np.testing.assert_array_equal(res.x, np.asarray(want.x))
        assert res.steps == want.steps == 3
        with pytest.raises(ValueError, match="square"):
            await svc.solve("t", "regular", x, steps=3)
        await svc.aclose()
        with pytest.raises(RequestRejected) as exc:
            await svc.multiply("t", "regular", x)
        assert exc.value.reason == "shutdown"

    _serve(svc, body)
    rejected = svc.stats()["tenants"]["t"]["rejected"]
    assert rejected["deadline_infeasible"] == 2 and rejected["shutdown"] == 1
    assert svc.served == 4  # 3 multiplies and the session


def test_backend_failure_propagates_and_drain_resolves_inflight():
    svc = _service(max_batch=8, max_delay_s=30.0)  # nothing flushes on time
    x = np.ones(128, np.float32)

    async def body(svc):
        futs = [asyncio.ensure_future(svc.multiply("t", "regular", x))
                for _ in range(5)]
        for _ in range(10):
            await asyncio.sleep(0)
        assert svc.batcher.pending() > 0
        await svc.drain()
        assert all(f.done() for f in futs) and svc.batcher.pending() == 0
        await asyncio.gather(*futs)
        svc.engine.cache.clear()  # plan evicted under live serving
        with pytest.raises(RuntimeError, match="evicted"):
            await svc.multiply("t", "regular", np.zeros((128, 2), np.float32))

    _serve(svc, body)
    assert svc.served == 5 and svc.errors == 1
    assert svc.stats()["tenants"]["t"]["pending"] == 0


def test_never_started_service_starts_lazily():
    a = matrices()["regular"]
    svc = _service(max_batch=8)
    x = np.ones(128, np.float32)

    async def main():
        try:
            return await asyncio.wait_for(svc.multiply("t", "regular", x),
                                          TIMEOUT)
        finally:
            await asyncio.wait_for(svc.aclose(), TIMEOUT)
            svc.batcher.stop(drain=False)

    np.testing.assert_array_equal(asyncio.run(main()), a @ x)


# --------------------------------------------------------------- replay


def _replay_spec(pkg, **kw):
    base = dict(names=NAMES, tenants=("a", "b", "c"), n_requests=48, seed=5,
                rate_rps=3000.0, arrivals="bursty", deadline_s=30.0,
                infeasible_frac=0.15, integer_values=True,
                tenant_classes={"a": "rt", "b": "standard", "c": "batch"})
    base.update(kw)
    return pkg.WorkloadSpec(**base)


def _replay(pkg, svc, oracles):
    trace = pkg.generate_trace(_replay_spec(pkg))
    tenants = pkg.tenant_configs(_replay_spec(pkg))
    for tenant, cfg in tenants.items():
        svc.admission.configure(tenant, cfg)
    return trace, _serve(svc, lambda s: pkg.replay(
        s, trace, oracles=oracles, time_scale=0.0, integer_values=True))


@pytest.mark.parametrize("parts", [1, 4])
def test_replay_zero_loss_bitexact_and_matches_jax(parts):
    mats = {n: matrices()[n] for n in NAMES}
    trace, report = _replay(tserve, _service(parts=parts), mats)
    _, want = _replay(jserve, _service(jserve), mats)
    assert report.lost == 0 and report.errors == 0
    assert report.completed + report.rejected == len(trace)
    n_infeasible = sum(r.infeasible for r in trace)
    assert report.infeasible_rejected == n_infeasible > 0
    assert report.infeasible_served == 0 and report.late == 0
    assert report.bitexact == report.verified == report.completed > 0
    assert report.max_abs_err == 0.0
    for field in ("requests", "completed", "rejected", "reject_reasons",
                  "infeasible_rejected", "verified", "bitexact"):
        assert getattr(report, field) == getattr(want, field), field
    assert set(report.per_class) == set(want.per_class) == {"rt", "standard",
                                                             "batch"}
    for cls, d in report.per_class.items():
        assert (d["completed"], d["rejected"], d["vectors"]) == \
            (want.per_class[cls]["completed"], want.per_class[cls]["rejected"],
             want.per_class[cls]["vectors"])
    assert abs(sum(report.phases[p] for p in ("load", "kernel", "retrieve"))
               - 1.0) < 1e-9
    assert report.describe() and report.to_dict()["lost"] == 0


def test_replay_with_tensor_oracles():
    mats = {n: torch.from_numpy(matrices()[n]) for n in NAMES}
    trace, report = _replay(tserve, _service(), mats)
    assert report.lost == 0 and report.errors == 0
    assert report.bitexact == report.verified == report.completed > 0


def test_replay_checks_the_oracles_outside_the_timed_window(monkeypatch):
    """The oracle checks run after the last request resolves: a slow oracle
    product delays no delivery (neither the latencies nor ``wall_s`` hold
    it), and every completion is still verified bit for bit.  Run inline on
    the event loop, 16 checks of 0.1 s would put up to 1.5 s into the
    latencies of the requests resolved after them."""
    import importlib

    # the package exports the function ``replay`` under the module's name
    treplay = importlib.import_module("repro_torch.serve.replay")
    slow, n = 0.1, 16
    apply = treplay._apply

    def slow_apply(a, x):
        time.sleep(slow)
        return apply(a, x)

    monkeypatch.setattr(treplay, "_apply", slow_apply)
    mats = {name: matrices()[name] for name in NAMES}
    trace = generate_trace(WorkloadSpec(names=NAMES, n_requests=n, seed=3,
                                        integer_values=True))
    t0 = time.perf_counter()
    report = _serve(_service(), lambda s: replay(
        s, trace, oracles=mats, time_scale=0.0, integer_values=True))
    assert time.perf_counter() - t0 >= n * slow  # the checks ran ...
    assert report.bitexact == report.verified == report.completed == n
    assert report.wall_s < n * slow / 2  # ... after the timed window
    assert report.latency["p99_ms"] < n * slow / 2 * 1e3


def test_replay_with_explicit_loop_and_disabled_tracer():
    svc = _service(tracer=tobs.Tracer(enabled=False))
    trace = generate_trace(WorkloadSpec(names=NAMES, n_requests=12, seed=1,
                                        integer_values=True))
    report = _serve(svc, lambda s: replay(s, trace, time_scale=0.0,
                                          integer_values=True))
    assert report.lost == 0 and report.completed == 12
    assert report.phase_latency == {} and report.span_coverage == 0.0
