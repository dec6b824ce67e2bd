"""Engine worker — one process, one SpmvEngine, one AF_UNIX listener.

Counterpart of ``repro/cluster/worker.py``.  The process analogue of a PIM
rank: it owns a private CUDA context on the card (or the CPU, for tests), a
private :class:`~repro_torch.engine.SpmvEngine`, and serves a small verb set
over the length-prefixed protocol in :mod:`repro_torch.cluster.protocol`:

  ``ping / register / multiply / solve / drain / stats / dump_trace /
  unregister / shutdown``

Plans arrive as IR, never as live objects: ``register`` accepts an
``ExecutionPlan.to_ir()`` record (of either package) and rehydrates it
against the worker's own device with :func:`repro_torch.api.plan_from_ir`,
and/or a ``tune_record`` — an exported :class:`~repro_torch.tune.TuningCache`
slice — which the worker ingests and replays through
:class:`~repro_torch.tune.Tuner` so the cached winner is rebuilt with **zero
re-measurements** (``from_cache=True``; the cache's ``hits`` counter is the
auditable proof, surfaced by ``stats``).  The matrix itself arrives dense
(``a``) or as coalesced triplets with int32 indices (``triplets`` +
``shape``): a 2M x 2M matrix has no dense form.

Workers are spawned with the ``spawn`` start method (never ``fork``: the
parent may hold a live CUDA context, which a forked child cannot use), so
``worker_main`` re-imports everything fresh in the child.  The heavyweight
imports happen inside the function for the same reason — importing this
module stays cheap for processes (routers, load generators) that never run
a worker loop themselves.  Replies hold numpy arrays and plain Python
values only, never a tensor: unpickling one would make the router or a
load generator import (and for a card tensor, initialise) CUDA.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

from .protocol import (
    ConnectionClosed,
    WorkerClient,
    WorkerLostError,
    recv_msg,
    send_msg,
)

__all__ = ["WorkerConfig", "WorkerHandle", "worker_main", "spawn_worker"]


@dataclass(frozen=True)
class WorkerConfig:
    """Everything a worker needs to build its engine (picklable: crosses
    the spawn boundary as a Process arg)."""

    worker_id: str
    impl: str = "cuda"  # engine-default tile kernel ("cuda" | "torch")
    cache_capacity: int = 8  # compiled plans held per worker (LRU)
    tune_cache_path: Optional[str] = None  # shared TuningCache file; the
    # multi-writer safety lives in tune/cache.py (file lock + merge-on-write)
    trace_capacity: int = 16384  # per-worker span ring size
    devices: Optional[tuple] = None  # the engine's parts: None = one part
    # on the card; ("cuda",) * 16 = 16 parts on it; ("cpu",) for tests


class _WorkerState:
    """The server side of one worker process (verb handlers + accounting)."""

    def __init__(self, config: WorkerConfig):
        # deferred heavyweight imports: only the worker process pays them
        from ..engine import SpmvEngine
        from ..obs import MetricsRegistry, Tracer
        from ..tune import TuningCache

        self.config = config
        self.engine = SpmvEngine(
            devices=None if config.devices is None else list(config.devices),
            cache_capacity=config.cache_capacity, impl=config.impl,
        )
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(capacity=config.trace_capacity)
        self.tune_cache = TuningCache(path=config.tune_cache_path)
        self.served = 0  # multiply verbs completed
        self._inflight = 0  # multiply verbs between recv and reply
        self._cv = threading.Condition()
        self.stopping = threading.Event()

    # ------------------------------------------------------------- verbs

    def ping(self, msg) -> dict:
        return {"worker_id": self.config.worker_id, "pid": os.getpid()}

    def _matrix(self, msg):
        """The request's matrix as a host SparseMatrix: from ``triplets``
        (rowind, colind, values) + ``shape``, else from the dense ``a``;
        ``dtype`` converts the values first."""
        import numpy as np

        from ..api import SparseMatrix

        dtype = msg.get("dtype")
        if msg.get("triplets") is not None:
            ri, ci, vals = msg["triplets"]
            if dtype is not None:
                vals = np.asarray(vals).astype(dtype)
            return SparseMatrix.from_parts(ri, ci, vals, tuple(msg["shape"]))
        a = np.asarray(msg["a"])
        if dtype is not None:
            a = a.astype(dtype)
        return SparseMatrix.from_dense(a, stats_block=self.engine.block)

    def register(self, msg) -> dict:
        """Plan + partition + place + compile one matrix on this worker.

        Fields: ``name`` (str), the matrix — ``a`` (dense ndarray) or
        ``triplets`` ((rowind, colind, values) arrays) with ``shape`` —
        optional ``dtype``, and the plan's provenance — exactly one of:

          * ``tune_record``: ``{"entries": {key: record}, "impls": [...],
            "batch": int|None, "block": [r, c]}`` — the exported TuningCache
            slice; ingested, then replayed through a Tuner whose only legal
            outcome here is a cache hit (zero re-measurements).
          * ``ir``: an ``ExecutionPlan.to_ir()`` dict, rehydrated against
            this worker's devices; a topology-placed IR's axis assignment
            stays in the reply's ``scheme_id`` (its ``@`` suffix).
          * neither: the worker plans adaptively (``scheme``/
            ``partitioning`` overrides pass through to the engine).

        The reply reports ``source`` ("tune_cache" | "ir" | "fresh"), the
        fitted ``scheme_id``, ``register_s`` (this verb's seconds on the
        worker) and — on the tune path — ``from_cache`` plus the cache hit
        counters, so callers can *assert* nothing was re-measured.
        """
        from ..api import plan_from_ir
        from ..tune import CandidateGenerator, Measurer, Tuner

        t0 = time.perf_counter()
        name = msg["name"]
        sm = self._matrix(msg)
        ir = msg.get("ir")
        tune_record = msg.get("tune_record")
        info: dict = {"worker_id": self.config.worker_id, "name": name}
        placement = ""  # a topology-placed IR's "@<axis assignment>"
        if tune_record is not None:
            self.tune_cache.ingest(dict(tune_record.get("entries", {})))
            block = tuple(tune_record.get("block", self.engine.block))
            tuner = Tuner(
                generator=CandidateGenerator(
                    impls=tuple(tune_record.get("impls", (self.config.impl,)))
                ),
                measurer=Measurer(),
                cache=self.tune_cache,
            )
            hits0 = self.tune_cache.hits
            result = tuner.tune(
                sm,
                devices=self.engine.devices,
                block=block,
                hw=self.engine.hw,
                batch=tune_record.get("batch"),
            )
            entry = self.engine.register(
                name, sm, plan=result.best.scheme, impl=result.best.impl,
            )
            info.update(
                source="tune_cache",
                from_cache=bool(result.from_cache),
                measurements=len(result.measurements),
                tune_hits=self.tune_cache.hits - hits0,
            )
        elif ir is not None:
            ep = plan_from_ir(ir, sm, device=self.engine.device,
                              devices=self.engine.devices)
            entry = self.engine.register(
                name, sm, plan=ep.scheme, impl=ep.impl,
            )
            placement = "".join(ep.scheme_id.partition("@")[1:])
            info.update(source="ir")
        else:
            entry = self.engine.register(
                name,
                sm,
                plan=msg.get("scheme"),
                partitioning=msg.get("partitioning"),
                impl=msg.get("impl"),
            )
            info.update(source="fresh")
        self.metrics.counter("cluster.worker.registered").inc()
        summary = entry.summary()
        info.update(
            fingerprint=summary["fingerprint"],
            scheme_id=summary["scheme_id"] + placement,
            impl=summary["impl"],
            shape=tuple(int(n) for n in summary["shape"]),
            dtype=summary["dtype"],
            register_s=time.perf_counter() - t0,
        )
        return info

    def multiply(self, msg) -> dict:
        """y = A @ x through the engine, traced (load/kernel/retrieve).

        An optional ``cls`` field (the caller's SLO class, forwarded by
        the router) labels the lifecycle span and the per-class served
        counter — absent for older callers, defaulting to ``standard``.
        """
        import numpy as np

        name = msg["name"]
        cls = msg.get("cls", "standard")
        tr = self.tracer.trace(label=f"{self.config.worker_id}:{name}")
        with tr.span("serve", cls=cls):
            y = self.engine.multiply(name, np.asarray(msg["x"]), obs=tr)
        self.served += 1
        self.metrics.counter("cluster.worker.served").inc()
        self.metrics.counter("cluster.worker.served", cls=cls).inc()
        return {"y": y, "worker_id": self.config.worker_id}

    def solve(self, msg) -> dict:
        """A whole solver session on this worker's engine.

        A session is *atomic*: its iteration state lives only in this
        process, so it either completes here or dies with the worker —
        the router must reject (never resume) a session whose worker was
        lost mid-run.  Fields mirror ``SpmvEngine.solve``: ``name``,
        ``x0``, and optionally ``steps`` / ``tol`` / ``combine`` /
        ``b`` / ``diag`` / ``omega`` / ``max_steps`` / ``check_every``;
        an optional ``cls`` (the session's SLO class) labels the span and
        the per-class solved counter.
        """
        import numpy as np

        name = msg["name"]
        cls = msg.get("cls", "standard")
        kwargs = {}
        for k in ("steps", "tol", "combine", "omega", "max_steps",
                  "check_every"):
            if msg.get(k) is not None:
                kwargs[k] = msg[k]
        for k in ("b", "diag"):
            if msg.get(k) is not None:
                kwargs[k] = np.asarray(msg[k])
        tr = self.tracer.trace(label=f"{self.config.worker_id}:{name}:solve")
        with tr.span("serve", cls=cls):
            result = self.engine.solve(
                name, np.asarray(msg["x0"]), obs=tr, **kwargs
            )
        self.served += 1
        self.metrics.counter("cluster.worker.solved").inc()
        self.metrics.counter("cluster.worker.solved", cls=cls).inc()
        return {
            "x": np.asarray(result.x),
            "steps": int(result.steps),
            "converged": bool(result.converged),
            "residual": float(result.residual),
            "seconds": float(result.seconds),
            "worker_id": self.config.worker_id,
        }

    def drain(self, msg) -> dict:
        """Block until every in-flight multiply (other than us) completes."""
        timeout = float(msg.get("timeout", 30.0))
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._inflight == 0, timeout=timeout
            )
        self.engine.drain_tuning()
        return {"drained": ok, "inflight": self._inflight}

    def stats(self, msg) -> dict:
        """Served counts, registry, telemetry, metrics, the tuning cache's
        counters and ``launches``: this process's kernel launch counters
        per kind (:mod:`repro_torch.kernels.instrument`; 0 on the CPU)."""
        from ..kernels import instrument

        return {
            "worker_id": self.config.worker_id,
            "pid": os.getpid(),
            "served": self.served,
            "registered": sorted(e.name for e in self.engine.registry),
            "entries": {
                e.name: e.summary() for e in self.engine.registry
            },
            "partition_count": self.engine.partition_count,
            "telemetry": self.engine.telemetry.breakdown(),
            "metrics": self.metrics.snapshot(),
            "tune_cache": {
                "hits": self.tune_cache.hits,
                "misses": self.tune_cache.misses,
                "entries": len(self.tune_cache),
            },
            "launches": instrument.snapshot(),
        }

    def dump_trace(self, msg) -> dict:
        """This worker's span buffer as one Chrome/Perfetto document."""
        from ..obs import chrome_trace

        return chrome_trace(self.tracer.spans())

    def unregister(self, msg) -> dict:
        self.engine.unregister(msg["name"])
        return {"unregistered": msg["name"]}

    def shutdown(self, msg) -> dict:
        self.stopping.set()
        return {"stopping": True}

    # ----------------------------------------------------------- dispatch

    def handle(self, msg) -> dict:
        verb = msg.get("verb")
        handler = getattr(self, verb, None) if verb and not \
            verb.startswith("_") else None
        if handler is None or verb in ("handle", "serve_connection"):
            raise ValueError(f"unknown verb {verb!r}")
        if verb in ("multiply", "solve"):
            with self._cv:
                self._inflight += 1
            try:
                return handler(msg)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
        return handler(msg)

    def serve_connection(self, conn: socket.socket) -> None:
        """Thread body: request/reply loop for one peer connection."""
        try:
            while not self.stopping.is_set():
                try:
                    msg = recv_msg(conn)
                except (ConnectionClosed, ValueError, OSError):
                    return  # peer hung up (or corrupted the stream): done
                try:
                    result = self.handle(msg)
                    reply = {"ok": True, "result": result}
                except Exception as e:  # verb failed; worker stays up
                    reply = {
                        "ok": False,
                        "error_type": type(e).__name__,
                        "error": str(e),
                        "traceback": traceback.format_exc(),
                    }
                try:
                    send_msg(conn, reply)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass


def worker_main(address: str, config: WorkerConfig) -> None:
    """Worker process entry point: bind, accept, serve until ``shutdown``.

    Runs in the spawned child.  One thread per connection (the router, each
    load generator and each chaos probe hold their own); ``shutdown`` stops
    the accept loop after the current replies flush.
    """
    state = _WorkerState(config)
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(address)
    except OSError:
        pass
    listener.bind(address)
    listener.listen(64)
    listener.settimeout(0.2)  # poll stopping between accepts
    threads = []
    try:
        while not state.stopping.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=state.serve_connection, args=(conn,), daemon=True
            )
            t.start()
            threads.append(t)
    finally:
        listener.close()
        try:
            os.unlink(address)
        except OSError:
            pass
        for t in threads:
            t.join(timeout=1.0)


@dataclass
class WorkerHandle:
    """Router-side handle: the child process + a control-plane client."""

    worker_id: str
    address: str
    process: object  # multiprocessing.Process (spawn context)
    client: WorkerClient
    lost: bool = False  # marked by the router on failover
    extra_clients: list = field(default_factory=list)

    def alive(self) -> bool:
        return self.process.is_alive()

    def connect(self, **kw) -> WorkerClient:
        """An additional data-plane connection (per-thread concurrency)."""
        c = WorkerClient(self.address, worker_id=self.worker_id, **kw)
        self.extra_clients.append(c)
        return c

    def kill(self) -> None:
        """SIGKILL the worker — the chaos hook behind the failover tests."""
        self.process.kill()
        self.process.join(timeout=10.0)

    def close(self, graceful: bool = True) -> None:
        if graceful and self.alive():
            try:
                self.client.request("shutdown")
            except Exception:
                pass
        for c in [self.client] + self.extra_clients:
            c.close()
        self.process.join(timeout=10.0)
        if self.process.is_alive():
            self.process.kill()
            self.process.join(timeout=10.0)
        try:
            os.unlink(self.address)
        except OSError:
            pass


def _connect(process, address: str, worker_id: str,
             connect_timeout: float) -> WorkerClient:
    """Connect to a starting worker, watching its process while waiting:
    a child that exits before binding raises at once with its exit code,
    not after ``connect_timeout``."""
    deadline = time.monotonic() + connect_timeout
    while True:
        if process.exitcode is not None:
            raise WorkerLostError(
                worker_id,
                f"exited with code {process.exitcode} before it answered",
            )
        try:
            return WorkerClient(
                address, worker_id=worker_id,
                connect_timeout=min(1.0, max(0.0, deadline - time.monotonic())),
            )
        except WorkerLostError:
            if time.monotonic() >= deadline:
                raise


def spawn_worker(
    worker_id: str,
    *,
    socket_dir: Optional[str] = None,
    connect_timeout: float = 120.0,
    **config_kw,
) -> WorkerHandle:
    """Spawn one engine worker and wait until it answers ``ping``.

    Uses the ``spawn`` start method: safe with a parent that holds a CUDA
    context, and the child inherits the parent's ``sys.path`` and
    environment.  Every worker builds its engine over the same ``devices``,
    which keeps :func:`repro_torch.tune.topology_key` consistent across the
    cluster (``cuda:1`` on the card, ``cpu:1`` on the CPU) — a prerequisite
    for shipped tune records to hit.  While it waits, it also watches the
    child: a worker that dies at import or start-up raises at once.

    Args:
      worker_id: cluster-unique identity (also the trace ``pid`` label).
      socket_dir: directory for the AF_UNIX socket (default: a fresh
        mkdtemp; AF_UNIX paths have a ~100-char limit, keep it short).
      connect_timeout: seconds to wait for the worker's first ping (the
        child pays a torch import before binding).
      **config_kw: WorkerConfig fields (impl, cache_capacity,
        tune_cache_path, trace_capacity, devices).

    Returns:
      A live WorkerHandle (ping verified).

    Raises:
      WorkerLostError: the child exited (its exit code in the message) or
        did not answer within ``connect_timeout``; the child is stopped.
    """
    import multiprocessing
    import tempfile

    if socket_dir is None:
        socket_dir = tempfile.mkdtemp(prefix="repro-cluster-")
    address = os.path.join(socket_dir, f"{worker_id}.sock")
    config = WorkerConfig(worker_id=worker_id, **config_kw)
    ctx = multiprocessing.get_context("spawn")
    process = ctx.Process(
        target=worker_main, args=(address, config),
        name=f"repro-worker-{worker_id}", daemon=True,
    )
    process.start()
    try:
        client = _connect(process, address, worker_id, connect_timeout)
        client.request("ping")
    except BaseException:
        process.kill()
        process.join(timeout=10.0)
        raise
    return WorkerHandle(
        worker_id=worker_id, address=address, process=process, client=client
    )
