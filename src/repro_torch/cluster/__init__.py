"""repro_torch.cluster — multi-process serving: plan IR + workers + router.

Counterpart of ``repro/cluster``, with the same exports.  SparseP's results
come from orchestrating thousands of PIM cores from a host-side software
stack that decides data placement and work routing above the kernels
(paper §4); this package scales :mod:`repro_torch.serve` past one Python
process, with every worker's engine on the one card:

  * :mod:`protocol` — the length-prefixed AF_UNIX wire protocol every
    router<->worker and generator<->worker byte moves through (frames of
    either package decode in the other), and the failure taxonomy
    (``WorkerLostError`` carries the ``worker_lost`` shed reason) failover
    keys on.
  * :mod:`worker` — one process, one CUDA context, one
    :class:`~repro_torch.engine.SpmvEngine`; plans arrive as
    ``ExecutionPlan.to_ir()`` records and exported
    :class:`~repro_torch.tune.TuningCache` slices, so a worker rehydrates
    tuned winners with **zero re-measurements** (its cache hit counters are
    the proof, surfaced by the ``stats`` verb, beside its kernel launch
    counters).
  * :mod:`router` — consistent-hash placement over matrix fingerprints
    (:class:`HashRing`), popularity-aware replication of the hot head,
    and failover: a dead worker's matrices re-register on the ring's next
    choice from the router's host-side copies (dense, or int32-index
    triplets of a :class:`~repro_torch.api.SparseMatrix`), mid-flight
    requests retry.
  * :mod:`replay` — the scaled replay harness: router-mode (threads, full
    failover on the path — the kill-a-worker probe) and generator-mode
    (``spawn``-ed load processes that never touch the card, hitting worker
    sockets directly), both verifying every reply bit-exactly against the
    host oracle.

Quickstart::

    from repro_torch.api import SparseMatrix
    from repro_torch.cluster import ClusterRouter

    with ClusterRouter(workers=2) as router:       # two engines on the card
        router.register("A", SparseMatrix.from_parts(ri, ci, vals, shape))
        y = router.multiply("A", x)                # routed, numpy in and out
        router.stats()                             # placements + worker stats

See docs/cluster.md (written for the JAX package; the port keeps its
protocol, placement policy, failover semantics and IR contract).
"""

from .protocol import (
    ConnectionClosed,
    RemoteError,
    WorkerClient,
    WorkerLostError,
    recv_msg,
    send_msg,
)
from .replay import (
    ClusterReport,
    generator_main,
    replay_cluster,
    replay_generators,
)
from .router import ClusterEntry, ClusterRouter, HashRing
from .worker import WorkerConfig, WorkerHandle, spawn_worker, worker_main

__all__ = [
    "ClusterRouter",
    "ClusterEntry",
    "HashRing",
    "WorkerConfig",
    "WorkerHandle",
    "spawn_worker",
    "worker_main",
    "WorkerClient",
    "WorkerLostError",
    "RemoteError",
    "ConnectionClosed",
    "send_msg",
    "recv_msg",
    "ClusterReport",
    "replay_cluster",
    "replay_generators",
    "generator_main",
]
