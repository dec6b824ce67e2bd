"""repro_torch.obs and the engine's Telemetry against the JAX package's.

The same sequence of calls (timestamps injected, so no clock enters the
comparison) goes through both packages' ``Tracer``, ``MetricsRegistry`` and
``Telemetry``; spans, Chrome traces, rollups, snapshots and breakdowns must
be equal.  ``profile.annotate`` must be the shared no-op while disabled.
"""
import sys
import threading

import numpy as np
import pytest

import repro.engine.telemetry as jtel
import repro.obs as jobs
import repro_torch.engine.telemetry as ttel
import repro_torch.obs as tobs
from repro_torch.obs import profile as tprofile

PACKAGES = [jobs, tobs]


def _span_tuple(s):
    return (s.trace_id, s.name, s.start_s, s.end_s, s.label, dict(s.args))


def _drive_tracer(obs, capacity):
    """A fixed script of traces and spans, every timestamp given."""
    tr = obs.Tracer(capacity=capacity)
    traces = [tr.trace(f"tenant-{k % 3}/m{k % 2}") for k in range(5)]
    t = 10.0
    for step in range(4):
        for k, trace in enumerate(traces):
            name = obs.PHASES[(step + k) % len(obs.PHASES)]
            trace.add(name, t, t + 0.001 * (k + 1), batch=k, step=step)
            t += 0.002
    return tr, traces


@pytest.mark.parametrize("capacity", [4, 16, 1024])
def test_tracer_spans_match_jax(capacity):
    (jt, jtr), (tt, ttr) = (_drive_tracer(p, capacity) for p in PACKAGES)
    assert [_span_tuple(s) for s in tt.spans()] == \
        [_span_tuple(s) for s in jt.spans()]
    assert (len(tt), tt.dropped) == (len(jt), jt.dropped)
    for a, b in zip(jtr, ttr):
        assert (b.trace_id, b.first_start, b.last_end) == \
            (a.trace_id, a.first_start, a.last_end)
    assert [_span_tuple(s) for s in tt.spans(trace_id=2, name="kernel")] == \
        [_span_tuple(s) for s in jt.spans(trace_id=2, name="kernel")]
    assert tobs.trace_summary(tt.spans()) == jobs.trace_summary(jt.spans())


def test_chrome_traces_match_jax():
    (jt, _), (tt, _) = (_drive_tracer(p, 1024) for p in PACKAGES)
    jdoc, tdoc = jt.chrome_trace(), tt.chrome_trace()
    # the process row names the package; every other event is equal
    for ev in jdoc["traceEvents"]:
        if ev["name"] == "process_name":
            ev["args"]["name"] = "repro_torch.serve replay"
    assert tdoc == jdoc
    labels = ["w0", "w1"]
    assert tobs.merge_chrome_traces([tdoc, {}], labels) == \
        jobs.merge_chrome_traces([jdoc, {}], labels)
    assert tobs.chrome_trace([]) == jobs.chrome_trace([])


def test_disabled_tracer_is_the_shared_noop():
    tr = tobs.Tracer(enabled=False)
    trace = tr.trace("x")
    assert trace is tobs.NULL_TRACE and not trace.enabled
    with trace.span("kernel") as inner:
        assert inner is tobs.NULL_TRACE
    trace.add("kernel", 0.0, 1.0)
    assert len(tr) == 0 and tr.spans() == []
    with pytest.raises(ValueError):
        tobs.Tracer(capacity=0)


def test_trace_span_context_and_threads():
    tr = tobs.Tracer()

    def work(k):
        trace = tr.trace(f"t{k}")
        for _ in range(50):
            with trace.span("kernel", k=k):
                pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(tr) == 400
    assert sorted({s.trace_id for s in tr.spans()}) == list(range(8))
    assert all(s.end_s >= s.start_s for s in tr.spans())


def _drive_metrics(obs, window):
    reg = obs.MetricsRegistry(histogram_window=window)
    rng = np.random.default_rng(3)
    for k in range(40):
        reason = ("queue_full", "rate_limited")[k % 2]
        reg.counter("serve.shed", reason=reason).inc()
        reg.gauge("serve.queue.depth", matrix="m", cls="rt").set(k % 7)
        reg.gauge("serve.inflight").inc(2)
        reg.gauge("serve.inflight").dec()
        reg.histogram("serve.latency.e2e_ms").observe(
            float(rng.exponential(3.0)))
        reg.histogram("serve.batch.width", cls="batch").observe(k % 8 + 1)
    return reg


@pytest.mark.parametrize("window", [8, 1024])
def test_metrics_snapshot_matches_jax(window):
    snaps = [_drive_metrics(p, window).snapshot() for p in PACKAGES]
    assert snaps[1] == snaps[0]


def test_metrics_errors_match_jax():
    for obs in PACKAGES:
        reg = obs.MetricsRegistry()
        reg.counter("a")
        with pytest.raises(TypeError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            reg.counter("b").inc(-1)


def test_histogram_percentiles_match_numpy():
    h = tobs.MetricsRegistry().histogram("h")
    vals = np.random.default_rng(0).standard_normal(500)
    for v in vals:
        h.observe(float(v))
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(float(np.percentile(vals, q)))


def test_profile_annotate_is_noop_when_disabled():
    before = tprofile._enabled
    try:
        assert tprofile.set_enabled(False) is False
        a = tprofile.annotate("spmv_kernel:m", batch=8)
        b = tprofile.step_annotate("s", 3)
        assert a is b is tprofile._NULL  # one shared object, no allocation
        with a:
            pass
        assert tprofile.set_enabled(True) is tprofile.profiler_available()
        with tprofile.annotate("plan_compile", impl="cuda"):
            with tprofile.step_annotate("batch", step=2):
                pass
        assert tprofile.annotate("x") is not tprofile._NULL
    finally:
        tprofile.set_enabled(before)


def _records(tel_mod):
    rng = np.random.default_rng(5)
    recs = []
    for k in range(30):
        load, kernel, retrieve = (float(v) for v in rng.random(3))
        recs.append(tel_mod.RequestRecord(
            name=("reg", "sf", "zero")[k % 3], batch=int(k % 4 + 1),
            load_s=0.0 if k % 3 == 2 else load,
            kernel_s=0.0 if k % 3 == 2 else kernel,
            retrieve_s=0.0 if k % 3 == 2 else retrieve,
            cache_hit=k > 2, traced=k < 3,
            kind="solve" if k % 10 == 9 else "multiply", steps=3))
    return recs


@pytest.mark.parametrize("max_records", [None, 7])
def test_telemetry_matches_jax(max_records):
    tels = []
    for mod in (jtel, ttel):
        tel = mod.Telemetry(max_records=max_records)
        for rec in _records(mod):
            tel.record(rec)
        tels.append(tel)
    jt, tt = tels
    assert tt.breakdown() == jt.breakdown()
    assert tt.breakdown("sf") == jt.breakdown("sf")
    assert [r.__dict__ for r in tt.records] == [r.__dict__ for r in jt.records]
    for name in ("reg", "sf", "zero", "none"):
        for fn in ("last", "last_solve"):
            got, want = getattr(tt, fn)(name), getattr(jt, fn)(name)
            assert (got is None and want is None) or got.__dict__ == want.__dict__
    tt.clear()
    assert tt.breakdown() == {} and tt.records == []


def test_telemetry_counts_every_record_from_8_threads():
    tel = ttel.Telemetry(max_records=None)
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=60)
        for _ in range(5000):
            tel.record(ttel.RequestRecord("m", 2, 1e-6, 2e-6, 1e-6,
                                          True, False))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    bd = tel.breakdown("m")
    assert (bd["requests"], bd["vectors"]) == (40000, 80000)
    assert len(tel.records) == 40000
