"""repro_torch.cluster against the JAX package's cluster, on the CPU.

* Protocol: the reference's four framing cases on the port, and frames
  crossing between the packages both ways on a ``socketpair``.
* The hash ring: the reference's four cases, then owners and successors
  equal to the JAX ``HashRing``'s for 1,000 keys, before and after a node
  leaves.  ``pick_session_worker`` over a sweep of loads and cursors, and
  ``ClusterReport.summary()`` for equal fields, equal to the reference's.
* A live fleet (module-scoped, two spawned port workers with
  ``devices=("cpu",)``, where every kernel wrapper runs its plain
  version): every answer bit-equal to the dense oracle (integer-valued
  matrices and payloads make float32 SpMV exact in any summation order)
  and to the one-device JAX engine, whose scheme ids the workers match;
  tune-record rehydration with zero measurements (the port's tuner in
  process, ``FakeMeasurer``, key ``cpu:1``); a JAX-made plan IR;
  popularity replication; drain and stats (with the ``launches``
  counters); the merged trace; concurrent multiplies; a JAX
  ``WorkerClient`` talking to a port worker.
* The port's own: a ``SparseMatrix`` registration (the fingerprint and
  placement of the dense one, answers bit-equal) travels as int32-index
  triplets, and no reply of any verb holds a ``torch.Tensor``.

The replay, failover, session and spawn tests are in
tests/test_torch_cluster_replay.py.  No JAX worker is ever spawned: each
JAX counterpart runs in this process.
"""
import socket
import threading

import jax
import numpy as np
import pytest
import torch

import repro.cluster as jcluster
import repro.cluster.protocol as jproto
import repro_torch.cluster as tcluster
import repro_torch.cluster.protocol as tproto
from repro.api import SparseMatrix as JSparseMatrix
from repro.engine import SpmvEngine as JEngine
from repro_torch.api import SparseMatrix
from repro_torch.cluster import ClusterRouter, HashRing
from repro_torch.cluster.protocol import (MAX_FRAME, ConnectionClosed,
                                          recv_msg, send_msg)
from repro_torch.cluster.replay import ClusterReport
from repro_torch.tune import CandidateGenerator, FakeMeasurer, Tuner, TuningCache

CPU = ("cpu",)
CONNECT_S = 120  # bound on a worker's start-up


def has_tensor(obj) -> bool:
    """Does ``obj`` (a decoded reply) hold a torch.Tensor anywhere?"""
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, dict):
        return any(has_tensor(k) or has_tensor(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return any(has_tensor(v) for v in obj)
    return False


# ------------------------------------------------------------ protocol


def test_package_exports_match_the_reference():
    assert tcluster.__all__ == jcluster.__all__
    assert tproto.MAGIC == jproto.MAGIC and tproto.MAX_FRAME == jproto.MAX_FRAME
    assert tproto.HEADER.format == jproto.HEADER.format


def test_protocol_roundtrip():
    a, b = socket.socketpair()
    try:
        msg = {"verb": "multiply", "x": np.arange(5.0), "name": "m"}
        send_msg(a, msg)
        got = recv_msg(b)
        assert got["verb"] == "multiply"
        np.testing.assert_array_equal(got["x"], msg["x"])
    finally:
        a.close()
        b.close()


def test_protocol_eof_is_connection_closed():
    a, b = socket.socketpair()
    a.close()
    try:
        with pytest.raises(ConnectionClosed):
            recv_msg(b)
    finally:
        b.close()


def test_protocol_bad_magic_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + (0).to_bytes(4, "big"))
        with pytest.raises(ValueError, match="magic"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_protocol_oversized_length_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(b"SPRP" + (MAX_FRAME + 1).to_bytes(4, "big"))
        with pytest.raises(ValueError, match="length"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("send,recv", [(tproto.send_msg, jproto.recv_msg),
                                       (jproto.send_msg, tproto.recv_msg)],
                         ids=["port_to_jax", "jax_to_port"])
def test_frames_cross_between_packages(send, recv):
    a, b = socket.socketpair()
    try:
        ri = np.arange(7, dtype=np.int32)
        msg = {"verb": "register", "name": "m", "triplets": (ri, ri, ri * 1.5),
               "shape": (7, 7), "dtype": "float32", "ir": None}
        send(a, msg)
        got = recv(b)
        assert set(got) == set(msg) and got["shape"] == (7, 7)
        for want, have in zip(msg["triplets"], got["triplets"]):
            np.testing.assert_array_equal(have, want)
            assert have.dtype == want.dtype
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ hash ring


def test_ring_lookup_deterministic_and_total():
    ring = HashRing()
    for w in ("w0", "w1", "w2"):
        ring.add(w)
    keys = [f"fp{i}" for i in range(200)]
    owners = {k: ring.lookup(k) for k in keys}
    assert owners == {k: ring.lookup(k) for k in keys}  # stable
    assert set(owners.values()) == {"w0", "w1", "w2"}  # all nodes used


def test_ring_removal_only_remaps_the_dead_node():
    ring = HashRing()
    for w in ("w0", "w1", "w2"):
        ring.add(w)
    keys = [f"fp{i}" for i in range(200)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("w1")
    after = {k: ring.lookup(k) for k in keys}
    for k in keys:
        if before[k] != "w1":
            assert after[k] == before[k]  # survivors' keys stay put
        else:
            assert after[k] in ("w0", "w2")


def test_ring_successors_distinct_and_ordered():
    ring = HashRing()
    for w in ("w0", "w1", "w2"):
        ring.add(w)
    succ = ring.successors("some-key", 3)
    assert len(succ) == 3 and len(set(succ)) == 3
    assert succ[0] == ring.lookup("some-key")
    assert ring.successors("some-key", 5) == succ  # only 3 nodes exist


def test_ring_empty_lookup_raises():
    with pytest.raises(LookupError):
        HashRing().lookup("fp")


def test_ring_matches_the_reference_for_1000_keys():
    rings = (HashRing(), jcluster.HashRing())
    for ring in rings:
        for w in ("w0", "w1", "w2"):
            ring.add(w)
    keys = [f"{i:016x}" for i in range(1000)]
    for _ in range(2):
        port, ref = rings
        assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
        assert ([port.successors(k, 3) for k in keys]
                == [ref.successors(k, 3) for k in keys])
        for ring in rings:
            ring.remove("w1")


# ------------------------------------------------ pure policy and report


def test_pick_session_worker_matches_the_reference():
    pick = ClusterRouter.pick_session_worker
    assert pick(["w0", "w1"], {"w0": 500}, 0) == "w1"
    assert pick(["w0", "w1"], {}, 1) == "w1"  # ties rotate with the cursor
    rng = np.random.default_rng(0)
    for _ in range(300):
        live = [f"w{i}" for i in range(int(rng.integers(1, 5)))]
        loads = {w: int(rng.integers(0, 4)) * 100 for w in live
                 if rng.random() < 0.7}
        rr = int(rng.integers(0, 9))
        assert pick(live, loads, rr) == jcluster.ClusterRouter.pick_session_worker(
            live, loads, rr)
    with pytest.raises(ValueError):
        pick([], {}, 0)


def test_cluster_report_summary_matches_the_reference():
    fields = dict(
        workers=2, requests=9, accepted=6, mismatched=0,
        shed=[{"reason": "worker_lost", "name": "a"},
              {"reason": "unknown_matrix", "name": "b"}],
        lost=1, wall_s=1.234567, latencies_s=[0.01, 0.002, 0.3, 0.04, 0.05, 0.6],
        per_worker={"w1": 2, "w0": 4},
        per_class={"rt": {"accepted": 4, "shed": 1, "mismatched": 0},
                   "batch": {"accepted": 2, "shed": 1, "mismatched": 0}},
        failovers=1,
    )
    port = ClusterReport(**fields)
    ref = jcluster.ClusterReport(**fields)
    assert port.summary() == ref.summary()
    assert port.accepted_rps == ref.accepted_rps and port.bit_exact


# ------------------------------------------------------- a live fleet


def _cluster_mats():
    rng = np.random.default_rng(3)
    mats = {}
    for name in ("hot", "warm", "cold"):
        a = np.round(rng.standard_normal((48, 40)) * 2.0).astype(np.float32)
        a[np.abs(a) < 1] = 0.0
        mats[name] = a
    return mats


def _request(mats, name, seed, batch=1):
    rng = np.random.default_rng(seed)
    cols = mats[name].shape[1]
    shape = (cols,) if batch == 1 else (cols, batch)
    return rng.integers(-3, 4, size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def cluster():
    mats = _cluster_mats()
    router = ClusterRouter(workers=2, devices=CPU, replicate_share=0.6,
                           replicate_check=4, connect_timeout=CONNECT_S)
    try:
        yield router, mats
    finally:
        router.close()


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(devices=jax.devices()[:1])


def test_cluster_register_and_bit_exact_multiply(cluster, jax_engine):
    router, mats = cluster
    for name, a in mats.items():
        info = router.register(name, a)
        assert info["placements"], info
        assert info["source"] == "fresh" and info["register_s"] > 0
        want = jax_engine.register(name, a)
        assert info["scheme_id"] == want.plan.tag
        assert info["fingerprint"] == want.fingerprint
    for name, a in mats.items():
        for seed, batch in ((1, 1), (2, 4)):
            x = _request(mats, name, seed, batch)
            y = router.multiply(name, x)
            assert np.array_equal(y, (a @ x).astype(np.float32))
            assert np.array_equal(y, np.asarray(jax_engine.multiply(name, x)))


def _spy(router):
    """Record every (verb, fields) the router sends to any worker."""
    seen = []
    for handle in router.workers.values():
        orig = handle.client.request

        def request(verb, _orig=orig, **fields):
            seen.append((verb, fields))
            return _orig(verb, **fields)

        handle.client.request = request
    return seen


def _unspy(router):
    for handle in router.workers.values():
        handle.client.__dict__.pop("request", None)


def test_sparse_matrix_registration_ships_int32_triplets(cluster):
    router, mats = cluster
    a = mats["warm"]
    sm = SparseMatrix.from_dense(a)
    seen = _spy(router)
    try:
        info = router.register("warm-sm", sm)
    finally:
        _unspy(router)
    (verb, fields), = seen
    assert verb == "register" and "a" not in fields
    ri, ci, vals = fields["triplets"]
    assert ri.dtype == ci.dtype == np.int32 and vals.dtype == np.float32
    assert fields["shape"] == a.shape and len(ri) == np.count_nonzero(a)
    dense = router.entries["warm"]
    assert info["fingerprint"] == dense.fingerprint == sm.fingerprint()
    assert info["placements"] == dense.placements
    assert info["scheme_id"] == dense.scheme_id
    for seed, batch in ((7, 1), (8, 4)):
        x = _request(mats, "warm", seed, batch)
        assert np.array_equal(router.multiply("warm-sm", x),
                              router.multiply("warm", x))
        assert np.array_equal(router.multiply("warm-sm", x),
                              (a @ x).astype(np.float32))


def test_cluster_tuned_rehydration_zero_measurements(cluster):
    """A worker receiving a tune record rebuilds the winner purely from its
    TuningCache: from_cache=True, zero measurements, hits counter moved."""
    router, mats = cluster
    a = mats["hot"]
    tuner = Tuner(generator=CandidateGenerator(impls=("cuda",)),
                  measurer=FakeMeasurer(), cache=TuningCache())
    result = tuner.tune(SparseMatrix.from_dense(a), devices=list(CPU))
    assert result.key.topology == "cpu:1" and not result.from_cache
    record = {"entries": tuner.cache.export(result.key), "impls": ["cuda"],
              "batch": None, "block": [8, 16]}
    info = router.register("hot-tuned", a, tune_record=record)
    assert info["source"] == "tune_cache"
    assert info["from_cache"] is True
    assert info["measurements"] == 0  # nothing was re-measured
    assert info["tune_hits"] >= 1  # the cache answered
    assert info["scheme_id"] == result.best.scheme_id
    x = _request(mats, "hot", 5)
    y = router.multiply("hot-tuned", x)
    assert np.array_equal(y, (a @ x).astype(np.float32))


def test_cluster_ir_registration_preserves_scheme(cluster, jax_engine):
    router, mats = cluster
    a = mats["warm"]
    ep = JSparseMatrix.from_dense(a).plan(scheme="1d.nnz", fmt="csr")
    info = router.register("warm-ir", a, ir=ep.to_ir())
    assert info["source"] == "ir"
    assert info["scheme_id"] == ep.scheme_id
    assert info["impl"] == "torch"  # the JAX "xla" impl, by its port name
    x = _request(mats, "warm", 6)
    y = router.multiply("warm-ir", x)
    assert np.array_equal(y, (a @ x).astype(np.float32))
    assert np.array_equal(y, np.asarray(ep.compile()(x)))


def test_jax_client_talks_to_a_port_worker(cluster):
    router, mats = cluster
    wid = router.entries["cold"].placements[0]
    client = jproto.WorkerClient(router.workers[wid].address, worker_id=wid,
                                 connect_timeout=10.0)
    try:
        assert client.request("ping")["worker_id"] == wid
        x = _request(mats, "cold", 9, 4)
        reply = client.request("multiply", name="cold", x=x)
        assert reply["worker_id"] == wid
        assert np.array_equal(reply["y"], (mats["cold"] @ x).astype(np.float32))
    finally:
        client.close()


def test_no_reply_holds_a_tensor(cluster):
    """Every verb's reply, as it comes off the wire, is numpy and plain
    Python (shutdown's is checked in tests/test_torch_cluster_replay.py,
    where a worker may stop)."""
    router, mats = cluster
    a = mats["cold"]
    wid = router.entries["cold"].placements[0]
    client = router.workers[wid].connect(connect_timeout=10.0)
    sm = SparseMatrix.from_dense(a)
    ep = sm.plan(scheme="1d.nnz", fmt="csr", device="cpu")
    tuner = Tuner(generator=CandidateGenerator(impls=("cuda",)),
                  measurer=FakeMeasurer(), cache=TuningCache())
    key = tuner.tune(sm, devices=list(CPU)).key
    record = {"entries": tuner.cache.export(key), "impls": ["cuda"],
              "batch": None, "block": [8, 16]}
    trip = tuple(t.numpy() for t in sm.coalesced())
    rng = np.random.default_rng(0)
    square = rng.integers(-2, 3, size=(24, 24)).astype(np.float32)
    replies = [
        client.request("ping"),
        client.request("register", name="t-square", a=square),
        client.request("solve", name="t-square", steps=3, combine="power",
                       x0=rng.integers(-2, 3, 24).astype(np.float32)),
        client.request("register", name="t-dense", a=a),
        client.request("register", name="t-trip", triplets=trip, shape=a.shape),
        client.request("register", name="t-ir", a=a, ir=ep.to_ir()),
        client.request("register", name="t-tune", a=a, tune_record=record),
        client.request("multiply", name="t-trip", x=_request(mats, "cold", 1)),
        client.request("multiply", name="t-dense", x=_request(mats, "cold", 2, 4)),
        client.request("drain"),
        client.request("stats"),
        client.request("dump_trace"),
    ]
    for name in ("t-square", "t-dense", "t-trip", "t-ir", "t-tune"):
        replies.append(client.request("unregister", name=name))
    for reply in replies:
        assert not has_tensor(reply), reply
    assert replies[2]["steps"] == 3 and isinstance(replies[2]["x"], np.ndarray)
    assert replies[-1]["unregistered"] == "t-tune"


def test_cluster_popularity_replicates_hot_matrix(cluster):
    router, mats = cluster
    entry = router.entries["hot"]
    for seed in range(80):  # all traffic to one name clears the threshold
        router.multiply("hot", _request(mats, "hot", 100 + seed))
    assert len(entry.placements) == 2, router.stats()["entries"]["hot"]


def test_cluster_drain_and_stats(cluster):
    router, mats = cluster
    drained = router.drain()
    assert drained and all(d["drained"] for d in drained.values())
    st = router.stats()
    assert set(st["workers"]) == {"w0", "w1"}
    served = sum(w.get("served", 0) for w in st["workers"].values())
    assert served >= st["routed"] / 8  # batches count once served
    for w in st["workers"].values():
        assert w["launches"].get("coo", 0) == w["launches"].get("bcoo", 0) == 0
        assert w["tune_cache"]["hits"] >= 0
        for e in w["entries"].values():
            assert {"scheme_id", "fingerprint", "requests"} <= set(e)
    assert not has_tensor(st)


def test_cluster_trace_merge_has_one_pid_per_worker(cluster):
    router, mats = cluster
    merged = router.dump_traces()
    by_pid = {}
    for ev in merged["traceEvents"]:
        if ev.get("ph") == "M" and ev["name"] == "process_name":
            by_pid[ev["pid"]] = ev["args"]["name"]
    assert sorted(by_pid.values()) == ["w0", "w1"]
    span_pids = {ev["pid"] for ev in merged["traceEvents"]
                 if ev.get("ph") == "X"}
    assert span_pids == {1, 2}  # both workers' spans made it across


def test_cluster_concurrent_multiplies_are_safe(cluster):
    router, mats = cluster
    errors = []

    def worker_thread(seed):
        try:
            for i in range(5):
                name = ("hot", "warm", "cold")[i % 3]
                x = _request(mats, name, seed * 100 + i)
                y = router.multiply(name, x)
                assert np.array_equal(
                    y, (mats[name] @ x).astype(np.float32)
                )
        except Exception as e:  # surfaced below; threads must not die silent
            errors.append(e)

    threads = [threading.Thread(target=worker_thread, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
