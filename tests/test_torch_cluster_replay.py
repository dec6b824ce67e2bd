"""repro_torch.cluster's replays, failover, sessions and worker spawn, on
the CPU (workers with ``devices=("cpu",)``).

After the reference's tests (tests/test_cluster.py, tests/test_slo.py,
tests/test_solver.py), each on its own disposable fleet that closes in a
``finally``:

* killing a worker mid-replay loses nothing and answers nothing wrong, in
  plain and in mixed-class form (per class too);
* a solver session on a lost worker is rejected, and the resubmitted one
  succeeds after the re-home, within the reference's tolerance of the
  float64 power loop;
* a generator-mode replay (two spawned load processes) is bit-exact;
* ``spawn_worker`` with a config that fails in the child raises
  ``WorkerLostError`` with its exit code within seconds;
* the ``shutdown`` verb's reply holds no tensor, and the worker exits.
"""
import time

import numpy as np
import pytest

import _solver_runner as sr
from repro_torch.cluster import ClusterRouter, WorkerLostError, spawn_worker
from repro_torch.cluster.replay import replay_cluster, replay_generators
from repro_torch.serve.workload import WorkloadSpec, generate_trace
from test_torch_cluster import CONNECT_S, CPU, _cluster_mats, _request, has_tensor


def _kill_replay(classes):
    mats = _cluster_mats()
    if classes:
        mats.pop("cold")
    spec = WorkloadSpec(
        names=tuple(mats), n_requests=40, seed=11, rate_rps=500.0,
        integer_values=True, batch_mix={1: 0.8, 4: 0.2},
        **({"tenants": ("fast", "bulk"), "tenant_classes": classes}
           if classes else {}),
    )
    trace = generate_trace(spec)
    router = ClusterRouter(workers=2, devices=CPU, connect_timeout=CONNECT_S)
    try:
        for name, a in mats.items():
            router.register(name, a, replicas=2)
        report = replay_cluster(router, trace, mats, threads=2,
                                kill_after=8, kill_worker="w0",
                                classes=classes)
        assert report.lost == 0, report.summary()
        assert report.bit_exact, report.summary()
        assert {s["reason"] for s in report.shed} <= {"worker_lost"}
        assert report.accepted + len(report.shed) == len(trace)
        assert report.failovers >= 1  # the kill was actually observed
        assert router.workers["w1"].alive()
        assert not router.workers["w0"].alive()
        x = _request(mats, "hot", 99)
        assert np.array_equal(router.multiply("hot", x),
                              (mats["hot"] @ x).astype(np.float32))
        return spec, trace, report, router.stats()
    finally:
        router.close()


def test_cluster_kill_worker_mid_replay_loses_nothing():
    _, _, report, stats = _kill_replay(None)
    assert stats["workers"]["w0"] == {"lost": True}
    assert report.per_worker["w1"] >= 1


def test_cluster_mixed_class_kill_replay_loses_nothing():
    spec, trace, report, stats = _kill_replay({"fast": "rt", "bulk": "batch"})
    per_trace = {}
    for req in trace:
        cls = spec.tenant_classes[req.tenant]
        per_trace[cls] = per_trace.get(cls, 0) + 1
    for cls, n in per_trace.items():
        d = report.per_class[cls]
        assert d["accepted"] + d["shed"] + d["mismatched"] == n
        assert d["mismatched"] == 0
    assert "per_class" in report.summary()
    assert "inflight_steps" in stats


def test_cluster_solve_rejected_on_worker_loss_then_rehomed():
    """A solver session is atomic: SIGKILL its worker and the session is
    rejected, while failover re-homes the matrix so a resubmit succeeds."""
    rng = np.random.default_rng(0)
    a = rng.integers(-2, 3, size=(24, 24)).astype(np.float32)
    x0 = rng.integers(-2, 3, size=24).astype(np.float32)
    ref = sr.np_power(a, x0, 6)
    router = ClusterRouter(workers=2, devices=CPU, connect_timeout=CONNECT_S)
    try:
        router.register("g", a)
        res = router.solve("g", x0, steps=6, combine="power")
        assert res["steps"] == 6
        np.testing.assert_allclose(res["x"].astype(np.float64), ref,
                                   atol=1e-5)
        entry = router.entries["g"]
        victim = entry.placements[entry.rr % len(entry.placements)]
        router.kill_worker(victim)
        with pytest.raises(WorkerLostError):
            router.solve("g", x0, steps=4, combine="power")
        res2 = router.solve("g", x0, steps=6, combine="power")
        np.testing.assert_allclose(res2["x"].astype(np.float64), ref,
                                   atol=1e-5)
        assert res2["worker_id"] != victim
        assert any(f["worker_id"] == victim for f in router.failovers)
        assert router.entries["g"].requests >= 12  # steps-weighted routing
    finally:
        router.close()


def test_cluster_generator_replay_is_bit_exact():
    mats = _cluster_mats()
    spec = WorkloadSpec(names=tuple(mats), n_requests=24, seed=5,
                        integer_values=True, batch_mix={1: 0.6, 4: 0.25, 8: 0.15})
    trace = generate_trace(spec)
    router = ClusterRouter(workers=2, devices=CPU, connect_timeout=CONNECT_S)
    try:
        for name, a in mats.items():
            router.register(name, a)
        report = replay_generators(router, trace, mats, generators=2,
                                   timeout=120.0)
        assert report.requests == len(trace), report.summary()
        assert report.accepted == len(trace) and report.bit_exact
        assert report.lost == 0 and not report.shed
        served = {w: s["served"] for w, s in router.stats()["workers"].items()}
        assert report.per_worker == {w: n for w, n in served.items() if n}
    finally:
        router.close()


def test_spawn_worker_fails_fast_on_a_child_that_dies():
    t0 = time.monotonic()
    with pytest.raises(WorkerLostError, match="exited with code 1"):
        spawn_worker("bad", impl="no-such-impl", devices=CPU,
                     connect_timeout=CONNECT_S)
    assert time.monotonic() - t0 < 30


def test_shutdown_reply_holds_no_tensor_and_the_worker_exits():
    handle = spawn_worker("solo", devices=CPU, connect_timeout=CONNECT_S)
    try:
        reply = handle.client.request("shutdown")
        assert reply == {"stopping": True} and not has_tensor(reply)
        handle.process.join(timeout=30)
        assert not handle.alive() and handle.process.exitcode == 0
    finally:
        handle.close(graceful=False)
