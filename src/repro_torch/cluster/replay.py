"""Cluster replay — drive the router (or workers directly) with a trace.

Counterpart of ``repro/cluster/replay.py``.  The oracle of a trace entry is
``(mats[name] @ x).astype(np.float32)``: ``mats`` holds dense arrays or,
for matrices with no dense form, ``scipy.sparse`` matrices — ``@`` and
``.shape`` work on both, and on integer-valued float32 inputs the product
is exact in any summation order.

Two drive modes, matching the two things a scaled replay must prove:

  * :func:`replay_cluster` — **router mode**: threads inside the calling
    process push the trace through :class:`~repro.cluster.ClusterRouter`,
    so the full failover machinery is on the request path.  This is the
    mode the kill-a-worker acceptance runs in: a worker death mid-replay
    must lose zero accepted requests (re-route) or, at absolute worst,
    shed with reason ``worker_lost`` — never return a wrong answer.
  * :func:`replay_generators` — **generator mode**: ``spawn``-ed load
    generator *processes* connect straight to the workers' sockets from a
    static placement snapshot and blast their trace shard, so the
    measured requests/s is not bottlenecked on one Python process's GIL.
    Generators speak protocol + numpy and never initialise CUDA (they
    import the port's workload module, which pulls in torch but no card),
    so the card holds only the workers' contexts.

Both modes verify every accepted reply **bit-exactly** against a local
dense oracle (``np.float64``-free: the workload's integer payloads make
float32 SpMV exact in any summation order), so "accepted" always means
"accepted *and correct*".
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..serve.workload import ServeRequest, request_vector

__all__ = ["ClusterReport", "replay_cluster", "replay_generators",
           "generator_main"]


@dataclass
class ClusterReport:
    """One cluster replay's scorecard (router or generator mode)."""

    workers: int
    requests: int = 0  # trace entries driven
    accepted: int = 0  # replies received AND bit-exact vs the oracle
    mismatched: int = 0  # replies received but wrong (must stay 0)
    shed: List[dict] = field(default_factory=list)  # {reason, name, ...}
    lost: int = 0  # requests with neither reply nor shed record
    wall_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    per_worker: Dict[str, int] = field(default_factory=dict)  # replies by
    # answering worker id (placement/served balance evidence)
    # {SLO class: {"accepted": n, "shed": n, "mismatched": n}} when the
    # replay was driven with a tenant -> class mapping
    per_class: Dict[str, Dict[str, int]] = field(default_factory=dict)
    failovers: int = 0  # router worker-loss events observed

    @property
    def accepted_rps(self) -> float:
        return self.accepted / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bit_exact(self) -> bool:
        return self.mismatched == 0

    def latency(self) -> dict:
        from ..serve.replay import _percentiles

        return _percentiles(self.latencies_s)

    def summary(self) -> dict:
        return {
            "workers": self.workers,
            "requests": self.requests,
            "accepted": self.accepted,
            "mismatched": self.mismatched,
            "shed": len(self.shed),
            "shed_reasons": sorted({s["reason"] for s in self.shed}),
            "lost": self.lost,
            "bit_exact": self.bit_exact,
            "wall_s": round(self.wall_s, 4),
            "accepted_rps": round(self.accepted_rps, 2),
            "per_worker": dict(sorted(self.per_worker.items())),
            "per_class": {c: dict(d) for c, d in
                          sorted(self.per_class.items())},
            "failovers": self.failovers,
            "latency": self.latency(),
        }

    def _class_account(self, cls: str, outcome: str) -> None:
        d = self.per_class.setdefault(
            cls, {"accepted": 0, "shed": 0, "mismatched": 0})
        d[outcome] += 1


def _oracle(mats: Dict[str, object], req: ServeRequest,
            x: np.ndarray) -> np.ndarray:
    a = mats[req.name]
    return (a @ x).astype(np.float32)


# ---------------------------------------------------------------- router mode


def replay_cluster(
    router,
    trace: Sequence[ServeRequest],
    mats: Dict[str, object],
    *,
    threads: int = 4,
    integer: bool = True,
    kill_after: Optional[int] = None,
    kill_worker: Optional[str] = None,
    classes: Optional[Dict[str, str]] = None,
) -> ClusterReport:
    """Drive ``trace`` through the router from ``threads`` local threads.

    Requests are issued as fast as the cluster absorbs them (throughput
    mode — arrival offsets order the trace but are not slept out; the
    single-process serve replay already covers SLO pacing).  Each thread
    holds its own data-plane connection per worker so requests to one
    worker from different threads do not serialize on one socket.

    Args:
      router: a live :class:`~repro.cluster.ClusterRouter` with every
        ``trace`` name already registered.
      trace: ServeRequests (only ``name``/``batch``/``seed`` are used).
      mats: name -> dense host matrix (or scipy.sparse matrix), the
        bit-equality oracle.
      threads: local issuing threads.
      integer: integer payloads (bit-exact oracle; keep True).
      kill_after: SIGKILL ``kill_worker`` once this many requests have
        completed — the mid-replay chaos probe.
      kill_worker: worker id to kill (default: the routers's first).
      classes: optional {tenant: SLO class} mapping
        (``WorkloadSpec.tenant_classes``); each request's class is
        forwarded on the wire and outcomes are additionally folded into
        ``report.per_class`` — the mixed-class kill replay asserts zero
        loss per class, not just in aggregate.

    Returns:
      A ClusterReport; ``lost`` is 0 and ``bit_exact`` True on a passing
      run, and every shed carries reason ``worker_lost``.
    """
    from .protocol import WorkerLostError

    report = ClusterReport(workers=len(router.workers))
    report.requests = len(trace)
    lock = threading.Lock()
    cursor = {"i": 0}
    done = {"n": 0}
    killed = {"done": kill_after is None}
    local = threading.local()

    def clients_for(wid: str):
        # one data-plane connection per (thread, worker), lazily opened
        if not hasattr(local, "clients"):
            local.clients = {}
        if wid not in local.clients:
            local.clients[wid] = router.workers[wid].connect()
        return local.clients[wid]

    def run():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(trace):
                    return
                cursor["i"] = i + 1
            req = trace[i]
            cls = (classes or {}).get(req.tenant, "standard")
            a = mats[req.name]
            x = request_vector(req, a.shape[1], integer=integer)
            t0 = time.perf_counter()
            try:
                y = router.multiply(req.name, x, client_for=clients_for,
                                    cls=cls)
            except WorkerLostError:
                with lock:
                    report.shed.append(
                        {"reason": "worker_lost", "name": req.name,
                         "cls": cls}
                    )
                    report._class_account(cls, "shed")
                continue
            except KeyError:
                with lock:
                    report.shed.append(
                        {"reason": "unknown_matrix", "name": req.name,
                         "cls": cls}
                    )
                    report._class_account(cls, "shed")
                continue
            lat = time.perf_counter() - t0
            ok = np.array_equal(y, _oracle(mats, req, x))
            with lock:
                done["n"] += 1
                if ok:
                    report.accepted += 1
                    report.latencies_s.append(lat)
                    report._class_account(cls, "accepted")
                else:
                    report.mismatched += 1
                    report._class_account(cls, "mismatched")
                if not killed["done"] and done["n"] >= kill_after:
                    killed["done"] = True
                    wid = kill_worker or next(iter(router.workers))
                    router.kill_worker(wid)

    t_start = time.perf_counter()
    pool = [threading.Thread(target=run, daemon=True)
            for _ in range(max(1, threads))]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    report.wall_s = time.perf_counter() - t_start
    report.lost = report.requests - report.accepted - report.mismatched \
        - len(report.shed)
    report.failovers = len(router.failovers)
    for wid, handle in router.workers.items():
        if handle.lost or not handle.alive():
            continue
        try:
            report.per_worker[wid] = handle.client.request("stats")["served"]
        except Exception:
            pass
    return report


# ------------------------------------------------------------ generator mode


def generator_main(shard, placement, mats, integer, conn,
                   classes=None) -> None:
    """Load-generator process body (top-level: crosses the spawn boundary).

    Connects directly to the workers in ``placement`` (a static
    ``{name: [(worker_id, address), ...]}`` snapshot — no router on the
    path, so no failover: a worker death here sheds with reason
    ``worker_lost``), replays its trace shard as fast as the workers
    absorb it, verifies every reply against the dense oracle locally, and
    ships one result dict back through ``conn``.  ``classes`` optionally
    maps tenants to SLO classes, forwarded on the wire per request.

    Deliberately card-free: the imports are protocol + numpy (and the
    workload module), so a generator never creates a CUDA context and its
    CPU time is the workload's, not a runtime's.
    """
    from .protocol import RemoteError, WorkerClient, WorkerLostError

    clients: Dict[str, WorkerClient] = {}
    result = {
        "requests": len(shard), "accepted": 0, "mismatched": 0,
        "shed": [], "latencies_s": [], "per_worker": {},
    }
    try:
        rr = 0
        for req in shard:
            cls = (classes or {}).get(req.tenant, "standard")
            targets = placement.get(req.name, [])
            if not targets:
                result["shed"].append(
                    {"reason": "unknown_matrix", "name": req.name}
                )
                continue
            wid, address = targets[rr % len(targets)]
            rr += 1
            a = mats[req.name]
            x = request_vector(req, a.shape[1], integer=integer)
            t0 = time.perf_counter()
            try:
                if wid not in clients:
                    clients[wid] = WorkerClient(
                        address, worker_id=wid, connect_timeout=10.0
                    )
                reply = clients[wid].request("multiply", name=req.name, x=x,
                                             cls=cls)
            except WorkerLostError:
                result["shed"].append(
                    {"reason": "worker_lost", "name": req.name,
                     "worker_id": wid}
                )
                continue
            except RemoteError as e:
                result["shed"].append(
                    {"reason": f"remote_error:{e.error_type}",
                     "name": req.name}
                )
                continue
            lat = time.perf_counter() - t0
            y = np.asarray(reply["y"])
            expect = (a @ x).astype(np.float32)
            if np.array_equal(y, expect):
                result["accepted"] += 1
                result["latencies_s"].append(lat)
                w = reply.get("worker_id", wid)
                result["per_worker"][w] = result["per_worker"].get(w, 0) + 1
            else:
                result["mismatched"] += 1
    finally:
        for c in clients.values():
            c.close()
        conn.send(result)
        conn.close()


def replay_generators(
    router,
    trace: Sequence[ServeRequest],
    mats: Dict[str, object],
    *,
    generators: int = 2,
    integer: bool = True,
    timeout: float = 300.0,
    classes: Optional[Dict[str, str]] = None,
) -> ClusterReport:
    """Blast ``trace`` at the workers from ``generators`` spawned processes.

    The trace is sharded round-robin; each generator gets the router's
    current placement snapshot and talks to worker sockets directly.  The
    router is only consulted before (snapshot) and after (failover count),
    so the measured throughput is worker-bound, not router-bound.
    ``classes`` (tenant -> SLO class) is forwarded to every generator.

    Returns:
      The merged ClusterReport across generators.
    """
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    placement = router.placement_snapshot()
    shards = [list(trace[g::generators]) for g in range(max(1, generators))]
    procs, pipes = [], []
    t_start = time.perf_counter()
    for shard in shards:
        parent, child = ctx.Pipe(duplex=False)
        p = ctx.Process(
            target=generator_main,
            args=(shard, placement, mats, integer, child, classes),
            daemon=True,
        )
        p.start()
        child.close()  # the child's end lives in the child now
        procs.append(p)
        pipes.append(parent)

    report = ClusterReport(workers=len(router.workers))
    for p, pipe in zip(procs, pipes):
        got = None
        if pipe.poll(timeout):
            got = pipe.recv()
        p.join(timeout=10.0)
        if p.is_alive():
            p.kill()
        if got is None:  # a generator died without reporting: all lost
            continue
        report.requests += got["requests"]
        report.accepted += got["accepted"]
        report.mismatched += got["mismatched"]
        report.shed.extend(got["shed"])
        report.latencies_s.extend(got["latencies_s"])
        for wid, n in got["per_worker"].items():
            report.per_worker[wid] = report.per_worker.get(wid, 0) + n
    report.wall_s = time.perf_counter() - t_start
    reported = report.accepted + report.mismatched + len(report.shed)
    report.lost = max(0, len(trace) - reported)
    report.failovers = len(router.failovers)
    return report
