"""ClusterRouter — placement, routing and failover over N engine workers.

Counterpart of ``repro/cluster/router.py``: the same ring (equal owners and
successors for equal keys), placement, replication, session and failover
policy.  Two departures: the workers' engines sit on the card
(``devices=``), and a matrix may be registered as a
:class:`repro_torch.api.SparseMatrix`, which the router keeps and ships as
coalesced triplets with int32 indices (12 bytes a nonzero), never dense.

The SparseP software stack's job above the kernels is deciding *where* data
lives and *which* rank answers a request (paper §4; Gómez-Luna et al.
§2.2 on the UPMEM SDK's rank-level work distribution).  This module is the
process-cluster analogue:

  * **Placement** is consistent hashing over matrix fingerprints
    (:class:`HashRing`, md5 + virtual nodes): a cold matrix lives on
    exactly one worker, chosen stably, so registering the same matrix
    twice — or re-registering after a worker death — lands deterministically.
  * **Popularity-aware replication**: the router tracks per-matrix request
    shares; a matrix absorbing more than ``replicate_share`` of traffic is
    replicated to the ring successors (hot head served by many workers,
    cold tail resident once — the Zipf skew the workload generator
    produces is exactly what this pays off on).
  * **SLO classes & solver-aware sessions**: ``multiply``/``solve`` carry
    the caller's SLO class on the wire (workers label their spans and
    served counters with it), and session placement weighs **in-flight
    solver steps** per worker: a new session lands on the live placement
    with the fewest steps still running, so one 500-step session does not
    serialize behind another while an idle replica waits (docs/slo.md).
  * **Failover**: a :class:`~repro_torch.cluster.protocol.WorkerLostError`
    mid-multiply removes the worker from the ring and re-registers every
    matrix it exclusively held — from the router's host-side copies — on
    the ring's new choice, then retries the request.  A request is lost
    only when *every* worker is gone (shed reason ``worker_lost``).
  * **Plans ship, workers compile**: `register` can tune once (or accept a
    caller plan), then sends the IR + exported TuningCache slice to every
    placement; each worker rehydrates locally with zero re-measurements
    (see docs/cluster.md#placement-and-failover).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .protocol import RemoteError, WorkerLostError
from .worker import WorkerHandle, spawn_worker

__all__ = ["HashRing", "ClusterEntry", "ClusterRouter"]


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing with virtual nodes.

    ``vnodes`` points per node smooth the key distribution; removing a node
    only remaps the keys it owned (the property failover leans on: the
    surviving placements of every other matrix stay put).
    """

    def __init__(self, vnodes: int = 64):
        self.vnodes = vnodes
        self._points: List[int] = []  # sorted vnode hashes
        self._owner: Dict[int, str] = {}  # vnode hash -> node id
        self._nodes: set = set()

    @property
    def nodes(self) -> set:
        return set(self._nodes)

    def add(self, node_id: str) -> None:
        if node_id in self._nodes:
            return
        self._nodes.add(node_id)
        for i in range(self.vnodes):
            h = _hash(f"{node_id}#{i}")
            # md5 collisions across distinct vnode labels are not a
            # realistic concern; last add wins if one ever happened
            if h not in self._owner:
                bisect.insort(self._points, h)
            self._owner[h] = node_id

    def remove(self, node_id: str) -> None:
        if node_id not in self._nodes:
            return
        self._nodes.discard(node_id)
        for i in range(self.vnodes):
            h = _hash(f"{node_id}#{i}")
            if self._owner.get(h) == node_id:
                del self._owner[h]
                idx = bisect.bisect_left(self._points, h)
                if idx < len(self._points) and self._points[idx] == h:
                    self._points.pop(idx)

    def lookup(self, key: str) -> str:
        """The node owning ``key`` (clockwise-next vnode)."""
        if not self._points:
            raise LookupError("hash ring is empty (no live workers)")
        idx = bisect.bisect(self._points, _hash(key)) % len(self._points)
        return self._owner[self._points[idx]]

    def successors(self, key: str, n: int) -> List[str]:
        """Up to ``n`` distinct nodes in ring order starting at ``key``'s
        owner — the replication order for hot matrices."""
        if not self._points:
            return []
        out: List[str] = []
        start = bisect.bisect(self._points, _hash(key))
        for i in range(len(self._points)):
            node = self._owner[self._points[(start + i) % len(self._points)]]
            if node not in out:
                out.append(node)
                if len(out) >= n:
                    break
        return out


@dataclass
class ClusterEntry:
    """Router-side record of one registered matrix.

    Keeps the host copy — dense, or coalesced triplets with int32 indices
    plus the shape: that is what makes failover re-registration possible
    without the original caller, and a dense copy is the router's dense
    oracle for verification layers above.
    """

    name: str
    fingerprint: str
    a: Optional[np.ndarray]  # host-side dense copy (failover source), or
    # None for a matrix registered as triplets
    dtype: str
    scheme_id: str
    ir: Optional[dict] = None  # plan IR shipped to every placement
    tune_record: Optional[dict] = None  # exported TuningCache slice
    placements: List[str] = field(default_factory=list)  # worker ids
    requests: int = 0  # vectors routed (batch of B counts B)
    rr: int = 0  # round-robin cursor over placements
    triplets: Optional[tuple] = None  # (rowind int32, colind int32, values)
    shape: Optional[tuple] = None  # (rows, cols) of the triplets

    def register_fields(self) -> dict:
        """The fields of the ``register`` frame that places this matrix."""
        matrix = ({"a": self.a} if self.triplets is None else
                  {"triplets": self.triplets, "shape": self.shape})
        return {"name": self.name, **matrix, "dtype": self.dtype,
                "ir": self.ir, "tune_record": self.tune_record}


class ClusterRouter:
    """Spawn N engine workers and route register/multiply/solve/drain at
    them.

    Thread-safe: replay drives ``multiply`` from many threads; placement
    mutations (registration, replication, failover) serialize on one lock
    while the multiply fast path only snapshots under it.

    Args:
      workers: worker process count.
      impl: engine-default tile kernel for every worker.
      devices: every worker engine's parts (``WorkerConfig.devices``):
        None = one part on the card, ``("cuda",) * 16`` = 16 parts on it,
        ``("cpu",)`` for tests.
      tune_cache_path: shared on-disk TuningCache; safe for all workers to
        write concurrently (file lock + merge-on-write in tune/cache.py).
      replicate_share: request share above which a matrix replicates to
        one more worker (checked every ``replicate_check`` routed
        requests).  >= 1.0 disables replication.
      replicate_check: routed-request cadence of the popularity check.
      socket_dir: AF_UNIX socket directory (default: fresh mkdtemp).
      connect_timeout: per-worker startup allowance (covers the torch
        import).
    """

    def __init__(
        self,
        workers: int = 2,
        *,
        impl: str = "cuda",
        devices: Optional[tuple] = None,
        tune_cache_path: Optional[str] = None,
        replicate_share: float = 0.5,
        replicate_check: int = 16,
        vnodes: int = 64,
        socket_dir: Optional[str] = None,
        connect_timeout: float = 120.0,
    ):
        if workers < 1:
            raise ValueError(f"need at least one worker, got {workers}")
        import tempfile

        self._lock = threading.RLock()
        self.ring = HashRing(vnodes=vnodes)
        self.workers: Dict[str, WorkerHandle] = {}
        self.entries: Dict[str, ClusterEntry] = {}
        self.replicate_share = replicate_share
        self.replicate_check = max(1, replicate_check)
        self.routed = 0  # total vectors routed (replication denominator)
        self.failovers: List[dict] = []  # worker-loss events (append-only)
        # solver steps dispatched but not yet completed, per worker id —
        # the load signal session placement minimizes over
        self._inflight_steps: Dict[str, int] = {}
        self._socket_dir = socket_dir or tempfile.mkdtemp(
            prefix="repro-cluster-"
        )
        for i in range(workers):
            wid = f"w{i}"
            handle = spawn_worker(
                wid,
                socket_dir=self._socket_dir,
                connect_timeout=connect_timeout,
                impl=impl,
                tune_cache_path=tune_cache_path,
                devices=None if devices is None else tuple(devices),
            )
            self.workers[wid] = handle
            self.ring.add(wid)

    # ---------------------------------------------------------- placement

    def _live(self, wid: str) -> Optional[WorkerHandle]:
        h = self.workers.get(wid)
        return h if h is not None and not h.lost else None

    def _register_on(self, wid: str, entry: ClusterEntry) -> dict:
        handle = self.workers[wid]
        info = handle.client.request("register", **entry.register_fields())
        if wid not in entry.placements:
            entry.placements.append(wid)
        return info

    def register(
        self,
        name: str,
        a,
        *,
        dtype=None,
        ir: Optional[dict] = None,
        tune_record: Optional[dict] = None,
        replicas: int = 1,
    ) -> dict:
        """Place ``a`` on the ring and register it with its worker(s).

        Args:
          name: serving handle for :meth:`multiply`.
          a: dense host matrix (the router keeps this copy for failover
            and for callers' oracle checks), or a
            :class:`repro_torch.api.SparseMatrix`, kept and shipped as its
            coalesced triplets with int32 indices (a matrix of tens of
            millions of nonzeros has no dense form, and its frame must
            stay under ``protocol.MAX_FRAME``).  Both forms of one matrix
            have the same fingerprint, so the same placement.
          dtype: optional value conversion before planning.
          ir: a plan IR (``ExecutionPlan.to_ir()``) every placement
            rehydrates — ship a tuned/explicit plan instead of having each
            worker re-plan.
          tune_record: exported TuningCache slice (see
            ``TuningCache.export``-shaped ``{"entries", "impls", "batch",
            "block"}``); workers ingest it and rebuild the winner with
            zero re-measurements.
          replicas: initial placement count (popularity may add more).

        Returns:
          The primary worker's register info (source, scheme_id, ...),
          plus ``placements``.
        """
        from ..api import SparseMatrix, fingerprint_matrix

        if isinstance(a, SparseMatrix):
            entry = self._triplet_entry(name, a, dtype)
        else:
            a = np.asarray(a)
            if dtype is not None:
                a = a.astype(dtype)
            entry = ClusterEntry(
                name=name,
                fingerprint=fingerprint_matrix(a),
                a=a,
                dtype=str(np.dtype(a.dtype).name),
                scheme_id="",
            )
        entry.ir, entry.tune_record = ir, tune_record
        with self._lock:
            targets = self.ring.successors(entry.fingerprint, max(1, replicas))
            info: dict = {}
            for wid in targets:
                info = self._register_on(wid, entry)
            entry.scheme_id = info.get("scheme_id", "")
            self.entries[name] = entry
            return {**info, "placements": list(entry.placements)}

    @staticmethod
    def _triplet_entry(name: str, sm, dtype) -> ClusterEntry:
        """A ClusterEntry holding ``sm``'s coalesced triplets (cast to
        ``dtype`` first), indices narrowed to int32.

        Raises:
          ValueError: a dimension does not fit int32 indices.
        """
        from ..api import SparseMatrix
        from ..core.formats import dtype_name

        if max(sm.shape) > np.iinfo(np.int32).max:
            raise ValueError(f"shape {sm.shape} does not fit int32 indices")
        if dtype is not None:
            sm = SparseMatrix.from_parts(*sm.triplets(dtype), sm.shape)
        ri, ci, vals = sm.coalesced()
        return ClusterEntry(
            name=name,
            fingerprint=sm.fingerprint(),
            a=None,
            dtype=dtype_name(sm.dtype),
            scheme_id="",
            triplets=(ri.numpy().astype(np.int32),
                      ci.numpy().astype(np.int32), vals.numpy()),
            shape=tuple(int(n) for n in sm.shape),
        )

    # ------------------------------------------------------------ routing

    def multiply(self, name: str, x, *, client_for=None,
                 cls: str = "standard") -> np.ndarray:
        """Route y = A @ x to one of ``name``'s placements.

        Round-robins across placements (replicated hot matrices spread
        load); a worker loss mid-request triggers failover + one retry per
        remaining worker.  ``client_for`` (worker_id -> WorkerClient) lets
        a replay thread use its own data-plane connections instead of the
        router's shared control client.  ``cls`` is the caller's SLO class,
        forwarded on the wire so the worker labels its spans and served
        counters with it.

        Raises:
          KeyError: unknown ``name``.
          WorkerLostError: every worker died (shed reason
            ``worker_lost``).
        """
        entry = self.entries.get(name)
        if entry is None:
            raise KeyError(f"matrix {name!r} is not registered "
                           f"(registered: {sorted(self.entries)})")
        x = np.asarray(x)
        batch = x.shape[1] if x.ndim == 2 else 1
        attempts = max(1, len(self.workers))
        last: Optional[Exception] = None
        for _ in range(attempts):
            with self._lock:
                live = [w for w in entry.placements if self._live(w)]
                if not live:
                    self._restore_entry(entry)
                    live = [w for w in entry.placements if self._live(w)]
                if not live:
                    break
                wid = live[entry.rr % len(live)]
                entry.rr += 1
                handle = self.workers[wid]
            client = client_for(wid) if client_for is not None else \
                handle.client
            try:
                result = client.request("multiply", name=name, x=x, cls=cls)
            except WorkerLostError as e:
                last = e
                self._on_worker_lost(wid)
                continue
            with self._lock:
                entry.requests += batch
                self.routed += batch
                if self.routed % self.replicate_check == 0:
                    self._maybe_replicate()
            return np.asarray(result["y"])
        raise WorkerLostError(
            getattr(last, "worker_id", "?"),
            f"no live placement for {name!r}",
        ) from last

    @staticmethod
    def pick_session_worker(live: List[str], inflight_steps: Dict[str, int],
                            rr: int) -> str:
        """The placement a new solver session should land on.

        Least-loaded by **in-flight solver steps** (a 500-step session is
        500 units of queueing, not 1 request), with the round-robin cursor
        rotating the scan order so ties spread instead of always breaking
        toward the same worker.  Pure so it is unit-testable without a
        live cluster.
        """
        if not live:
            raise ValueError("no live placements to pick from")
        k = rr % len(live)
        ordered = live[k:] + live[:k]
        return min(ordered, key=lambda w: inflight_steps.get(w, 0))

    def solve(self, name: str, x0, *, client_for=None, cls: str = "standard",
              **solve_kwargs) -> dict:
        """Route a whole solver session to one of ``name``'s placements.

        Placement is **solver-aware**: among the live placements the
        session lands on the worker with the fewest in-flight solver steps
        (:meth:`pick_session_worker`) — the session's ``steps`` budget
        (or ``max_steps``, default 1000, in tol mode) is charged against
        the worker for the session's duration.  ``cls`` is the caller's
        SLO class, forwarded on the wire.

        Unlike :meth:`multiply`, a session is **never retried**: its
        iteration state lives only in the worker that ran it, so a
        re-run on another worker would silently restart from ``x0`` and
        bill the caller for work that never composed.  A
        ``WorkerLostError`` mid-session therefore still triggers
        failover (the matrix is re-homed so *subsequent* traffic
        survives) but the session itself is rejected — the error
        propagates to the caller, who may resubmit knowingly.

        Returns:
          The worker's session record: ``{"x", "steps", "converged",
          "residual", "seconds", "worker_id"}``.

        Raises:
          KeyError: unknown ``name``.
          WorkerLostError: the session's worker died mid-run (rejected,
            matrix re-homed), or no live placement existed to start it.
        """
        entry = self.entries.get(name)
        if entry is None:
            raise KeyError(f"matrix {name!r} is not registered "
                           f"(registered: {sorted(self.entries)})")
        x0 = np.asarray(x0)
        steps_budget = int(solve_kwargs.get("steps")
                           or solve_kwargs.get("max_steps") or 1000)
        with self._lock:
            live = [w for w in entry.placements if self._live(w)]
            if not live:
                self._restore_entry(entry)
                live = [w for w in entry.placements if self._live(w)]
            if not live:
                raise WorkerLostError("?", f"no live placement for {name!r}")
            wid = self.pick_session_worker(live, self._inflight_steps,
                                           entry.rr)
            entry.rr += 1
            self._inflight_steps[wid] = \
                self._inflight_steps.get(wid, 0) + steps_budget
            handle = self.workers[wid]
        client = client_for(wid) if client_for is not None else handle.client
        try:
            result = client.request("solve", name=name, x0=x0, cls=cls,
                                    **solve_kwargs)
        except WorkerLostError:
            # Re-home for future traffic, then reject THIS session: a
            # silent retry would be a silent restart.
            self._on_worker_lost(wid)
            raise
        finally:
            with self._lock:
                self._inflight_steps[wid] = max(
                    0, self._inflight_steps.get(wid, 0) - steps_budget)
        with self._lock:
            entry.requests += int(result["steps"])
            self.routed += int(result["steps"])
            self._maybe_replicate()
        result["x"] = np.asarray(result["x"])
        return result

    # ----------------------------------------------------------- failover

    def _on_worker_lost(self, wid: str) -> None:
        """Drop ``wid`` from the ring and re-home what it exclusively held."""
        with self._lock:
            handle = self.workers.get(wid)
            if handle is None or handle.lost:
                return  # another thread already handled this loss
            handle.lost = True
            self.ring.remove(wid)
            orphaned = []
            for entry in self.entries.values():
                if wid in entry.placements:
                    entry.placements.remove(wid)
                    if not entry.placements:
                        orphaned.append(entry.name)
            event = {"worker_id": wid, "rehomed": []}
            for name in orphaned:
                try:
                    self._restore_entry(self.entries[name])
                    event["rehomed"].append(name)
                except Exception as e:  # every worker gone; multiply sheds
                    event["error"] = f"{type(e).__name__}: {e}"
            self.failovers.append(event)

    def _restore_entry(self, entry: ClusterEntry) -> None:
        """Re-register ``entry`` from the host copy on the ring's current
        choice (caller holds the lock)."""
        if not self.ring.nodes:
            return
        wid = self.ring.lookup(entry.fingerprint)
        if wid not in entry.placements:
            self._register_on(wid, entry)

    def kill_worker(self, wid: str) -> None:
        """SIGKILL one worker (chaos hook; failover then exercises the
        real loss path on the next routed request)."""
        self.workers[wid].kill()

    # --------------------------------------------------------- replication

    def _maybe_replicate(self) -> None:
        """Replicate any matrix whose request share clears the threshold
        to one more ring successor (caller holds the lock)."""
        if self.replicate_share >= 1.0 or self.routed <= 0:
            return
        live_n = len(self.ring.nodes)
        for entry in self.entries.values():
            share = entry.requests / self.routed
            if share >= self.replicate_share and \
                    len(entry.placements) < live_n:
                for wid in self.ring.successors(
                    entry.fingerprint, len(entry.placements) + 1
                ):
                    if wid not in entry.placements and self._live(wid):
                        try:
                            self._register_on(wid, entry)
                        except (WorkerLostError, RemoteError):
                            pass  # replication is best-effort
                        break

    # ------------------------------------------------------------- fleet

    def drain(self, timeout: float = 30.0) -> dict:
        """Cross-worker drain: every live worker finishes its in-flight
        multiplies before this returns."""
        out = {}
        for wid, handle in self.workers.items():
            if handle.lost or not handle.alive():
                continue
            try:
                out[wid] = handle.client.request("drain", timeout=timeout)
            except WorkerLostError:
                self._on_worker_lost(wid)
        return out

    def stats(self) -> dict:
        """Router placement map + every live worker's stats verb."""
        workers = {}
        for wid, handle in self.workers.items():
            if handle.lost or not handle.alive():
                workers[wid] = {"lost": True}
                continue
            try:
                workers[wid] = handle.client.request("stats")
            except WorkerLostError:
                self._on_worker_lost(wid)
                workers[wid] = {"lost": True}
        with self._lock:
            placements = {
                name: {
                    "placements": list(e.placements),
                    "requests": e.requests,
                    "scheme_id": e.scheme_id,
                    "fingerprint": e.fingerprint,
                }
                for name, e in self.entries.items()
            }
        with self._lock:
            inflight = {w: n for w, n in self._inflight_steps.items() if n}
        return {
            "workers": workers,
            "entries": placements,
            "routed": self.routed,
            "inflight_steps": inflight,
            "failovers": list(self.failovers),
        }

    def dump_traces(self) -> dict:
        """All live workers' span buffers merged into one Chrome document
        (one ``pid`` per worker; see obs.merge_chrome_traces)."""
        from ..obs import merge_chrome_traces

        docs, labels = [], []
        for wid, handle in self.workers.items():
            if handle.lost or not handle.alive():
                continue
            try:
                docs.append(handle.client.request("dump_trace"))
                labels.append(wid)
            except WorkerLostError:
                self._on_worker_lost(wid)
        return merge_chrome_traces(docs, labels=labels)

    def placement_snapshot(self) -> dict:
        """{name: [(worker_id, address), ...]} — what a load generator
        needs to talk to workers directly (static; no failover)."""
        with self._lock:
            return {
                name: [
                    (wid, self.workers[wid].address)
                    for wid in e.placements
                    if self._live(wid)
                ]
                for name, e in self.entries.items()
            }

    def close(self) -> None:
        """Shut every worker down (graceful verb, then kill on timeout)."""
        for handle in self.workers.values():
            try:
                handle.close(graceful=not handle.lost)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
