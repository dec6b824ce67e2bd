"""repro_torch.serve — asyncio multi-tenant SpMV serving with admission
control.

Counterpart of ``repro/serve``, with the same exports.

The paper's end-to-end claim is SpMV *at scale* — thousands of PIM cores
behind real traffic.  :mod:`repro_torch.engine` amortizes the per-matrix costs;
this package is the front door that turns it into a servable system:

  * :mod:`service`   — ``AsyncSpmvService``: ``await multiply(tenant, name,
                       x, deadline_s=...)`` bridging the MicroBatcher onto
                       the event loop, ``await solve(...)`` for on-device
                       solver sessions, with ``drain()``/``aclose()``
  * :mod:`admission` — per-tenant bounded pending queues, token-bucket rate
                       limits, deadline-based load shedding
                       (``RequestRejected`` with a machine-readable reason),
                       and SLO classes (``rt``/``standard``/``batch``) that
                       drive priority-aware batch formation and the
                       class-aware queue-wait model (docs/slo.md)
  * :mod:`workload`  — seeded synthetic traffic: Zipfian matrix popularity,
                       Poisson/bursty arrivals, mixed vector/batch requests
  * :mod:`replay`    — fire a trace at a service and score it: p50/p95/p99,
                       reject rate, fairness, zero-loss accounting, Fig.-17
                       phase splits, dense-oracle verification

Knobs and report fields: ``docs/serving.md`` (written for the JAX package;
the port keeps its names).
"""

from .admission import (
    CLASS_DEADLINE_DEFAULTS,
    CLASS_RATE_WEIGHTS,
    REJECT_REASONS,
    SLO_CLASSES,
    AdmissionController,
    RequestRejected,
    TenantConfig,
    TenantState,
    TokenBucket,
    class_rank,
    class_rate_weight,
    default_deadline,
)
from .replay import SLOReport, replay, replay_sync
from .service import AsyncSpmvService
from .workload import (
    ServeRequest,
    WorkloadSpec,
    describe_trace,
    generate_trace,
    popularity,
    request_vector,
    tenant_configs,
)

__all__ = [
    "AsyncSpmvService",
    "AdmissionController",
    "TenantConfig",
    "TenantState",
    "TokenBucket",
    "RequestRejected",
    "REJECT_REASONS",
    "SLO_CLASSES",
    "CLASS_RATE_WEIGHTS",
    "CLASS_DEADLINE_DEFAULTS",
    "class_rank",
    "class_rate_weight",
    "default_deadline",
    "WorkloadSpec",
    "ServeRequest",
    "generate_trace",
    "request_vector",
    "popularity",
    "describe_trace",
    "tenant_configs",
    "SLOReport",
    "replay",
    "replay_sync",
]
