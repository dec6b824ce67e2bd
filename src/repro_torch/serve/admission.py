"""Admission control — bounded tenant queues, token buckets, load shedding.

Counterpart of ``repro/serve/admission.py`` (pure Python).

A serving front end that accepts every request degrades for everyone at
once: queues grow without bound, every deadline is missed, and one noisy
tenant starves the rest (the PIM-serving analogue of Gómez-Luna et al.'s
observation that the load step, not the kernel, saturates first).  The
controller therefore rejects *early*, per tenant, on three independent
budgets:

  * **pending bound** — each tenant holds at most ``max_pending`` admitted
    requests in flight; the next one is rejected with ``queue_full``.  This
    is the isolation mechanism: an overloaded tenant exhausts its own bound
    and everyone else's queue stays shallow.
  * **token bucket** — sustained rate ``rate_rps`` with burst capacity
    ``burst``; vectors above it are rejected with ``rate_limited``.  Bursts
    up to ``burst`` vectors pass untouched (Zipfian traffic is bursty; a
    hard per-second cap would shed exactly the traffic batching is best at).
  * **deadline feasibility** — a request whose SLO cannot be met even if it
    ran immediately (deadline below the observed service-time estimate) is
    rejected with ``deadline_infeasible`` instead of being served late.
    Shedding infeasible work is the paper-era wisdom of every SLO system:
    a late answer costs the same as a rejection but also delays everyone
    behind it.
  * **queue-aware feasibility** — bare service time is a lie under backlog:
    a request behind ``d`` queued vectors waits ~``d x estimate`` before its
    own service even starts.  With a ``queue_depth`` (the serving layer
    reads it off the batcher's queue-depth gauge), the controller models
    expected completion as ``(queue_depth + 1) x estimate`` and sheds on
    that sum with ``queue_wait_infeasible`` — closing the deep-backlog hole
    where a deadline covering one service time was admitted into a queue
    holding ten.

Tenants additionally carry an **SLO class** (``TenantConfig.priority``, one
of :data:`SLO_CLASSES`): the micro-batcher serves higher classes first and
the queue-wait model above counts only equal-or-higher-priority vectors as
"ahead" — a deep ``batch`` backlog no longer sheds a tight-deadline ``rt``
request that would in fact jump the queue.  See docs/slo.md for the class
semantics and the tuning cookbook.

All decisions are O(1) and synchronous; the asyncio service calls
:meth:`AdmissionController.admit` on the event loop thread only.  With a
:class:`repro_torch.obs.MetricsRegistry` attached, every shed increments a
``serve.shed{reason=...}`` counter (plus a class-labeled
``serve.shed{cls=...,reason=...}`` twin) and token buckets export a
``serve.tokens.remaining{tenant=...}`` gauge.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = [
    "REJECT_REASONS",
    "SLO_CLASSES",
    "CLASS_RATE_WEIGHTS",
    "CLASS_DEADLINE_DEFAULTS",
    "class_rank",
    "class_rate_weight",
    "default_deadline",
    "RequestRejected",
    "TokenBucket",
    "TenantConfig",
    "TenantState",
    "AdmissionController",
]

REJECT_REASONS = (
    "queue_full",
    "rate_limited",
    "deadline_infeasible",
    "queue_wait_infeasible",
    "shutdown",
)

#: SLO classes, most urgent first.  A tenant's class decides batch-formation
#: order in the MicroBatcher (rt preempts standard preempts batch, bounded
#: by the starvation guard) and which queued vectors the class-aware
#: queue-wait admission model counts as "ahead".
SLO_CLASSES = ("rt", "standard", "batch")

#: The class tenants get when none is configured.
DEFAULT_CLASS = "standard"

#: Token-bucket refill multiplier per SLO class: a configured ``rate_rps``
#: is the *standard* rate, and the tenant's class scales it — rt bursts
#: refill twice as fast as standard, batch at half speed — so the same
#: nominal budget buys urgency-proportional throughput instead of every
#: class spending one shared rate (docs/slo.md#class-weighted-buckets).
CLASS_RATE_WEIGHTS = {"rt": 2.0, "standard": 1.0, "batch": 0.5}

#: Implicit deadline per SLO class, applied by the service when a request
#: arrives with no explicit ``deadline_s``.  ``batch`` work carries a loose
#: default so queue-wait shedding has something to compare against (an
#: unbounded batch backlog is exactly the load the paper's retrieve phase
#: collapses under); rt/standard stay ``None`` — interactive callers are
#: expected to state their SLO, and an invented tight default would shed
#: traffic the operator never asked to shed.
CLASS_DEADLINE_DEFAULTS = {"rt": None, "standard": None, "batch": 30.0}


def class_rate_weight(priority: str) -> float:
    """The refill multiplier of an SLO class (see CLASS_RATE_WEIGHTS)."""
    class_rank(priority)
    return CLASS_RATE_WEIGHTS.get(priority, 1.0)


def default_deadline(priority: str) -> Optional[float]:
    """The implicit deadline of an SLO class, or None (no implicit SLO)."""
    class_rank(priority)
    return CLASS_DEADLINE_DEFAULTS.get(priority)


def class_rank(priority: str) -> int:
    """Numeric rank of an SLO class: 0 is the most urgent (``rt``).

    Lower rank is served first; the rank is what the MicroBatcher sorts on
    and what :meth:`MicroBatcher.pending_ahead` compares against.

    Raises:
      ValueError: for a class not in :data:`SLO_CLASSES`.
    """
    try:
        return SLO_CLASSES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown SLO class {priority!r}; expected one of {SLO_CLASSES}"
        ) from None


class RequestRejected(RuntimeError):
    """A request the admission controller refused to enqueue.

    Attributes:
      tenant: the tenant whose budget rejected the request.
      reason: one of :data:`REJECT_REASONS`.
    """

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        self.tenant = tenant
        self.reason = reason
        msg = f"request rejected for tenant {tenant!r}: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    One token admits one vector (a batch of B spends B tokens), so the
    budget is throughput in vectors, not request count.  Time is injected
    per call so tests (and the trace replayer) can drive it densely.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, rate)
        if self.burst < 1.0:
            raise ValueError(f"burst must admit at least one token, got {burst}")
        self._tokens = self.burst
        self._last = None  # first take() starts the clock

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        """Spend ``n`` tokens if available; refills lazily from elapsed time."""
        now = time.monotonic() if now is None else now
        if self._last is None:
            self._last = now
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant admission budgets (all knobs optional).

    Attributes:
      max_pending: admitted-but-unfinished request bound (the queue depth
        this tenant may pin); ``None`` disables the bound.
      rate_rps: sustained token-bucket rate in vectors/s; ``None`` disables
        rate limiting.
      burst: bucket capacity in vectors (default: ``max(1, rate_rps)``).
      priority: the tenant's SLO class, one of :data:`SLO_CLASSES`
        (default ``"standard"``).  ``rt`` traffic preempts batch formation
        and sees only equal-or-higher-priority vectors in the queue-wait
        admission model; ``batch`` traffic yields to both.  See
        docs/slo.md.
    """

    max_pending: Optional[int] = 64
    rate_rps: Optional[float] = None
    burst: Optional[float] = None
    priority: str = DEFAULT_CLASS

    def __post_init__(self):
        class_rank(self.priority)  # raise early on an unknown class


@dataclass
class TenantState:
    """Live admission state + counters for one tenant."""

    config: TenantConfig
    bucket: Optional[TokenBucket] = None
    pending: int = 0  # admitted requests not yet finished
    accepted: int = 0  # requests admitted (batch counts once)
    completed: int = 0
    vectors: int = 0  # vectors admitted (batch of B counts B)
    rejected: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(REJECT_REASONS, 0)
    )

    @property
    def rejected_total(self) -> int:
        return sum(self.rejected.values())


class AdmissionController:
    """Per-tenant admit/deny with bounded queues, buckets and shedding."""

    def __init__(self, default: Optional[TenantConfig] = None,
                 safety: float = 1.0, metrics=None):
        """Args:
          default: budgets applied to tenants without an explicit
            :meth:`configure` call (default: ``TenantConfig()``).
          safety: deadline feasibility margin — a request is infeasible when
            ``deadline_s < estimate_s * safety``; raise above 1.0 to shed
            earlier (protects the p99 at the cost of the reject rate).
          metrics: optional :class:`repro_torch.obs.MetricsRegistry` —
            shed-by-reason counters and tokens-remaining gauges land here.
        """
        if safety <= 0:
            raise ValueError(f"safety must be > 0, got {safety}")
        self.default = default if default is not None else TenantConfig()
        self.safety = float(safety)
        self.metrics = metrics
        self._tenants: Dict[str, TenantState] = {}

    # ----------------------------------------------------------- tenancy

    def configure(self, tenant: str, config: TenantConfig) -> TenantState:
        """Install (or replace) a tenant's budgets; counters are kept."""
        state = self._tenants.get(tenant)
        if state is None:
            state = self._make_state(config)
            self._tenants[tenant] = state
        else:
            state.config = config
            state.bucket = self._make_bucket(config)
        return state

    def state(self, tenant: str) -> TenantState:
        """The tenant's live state, created from the default config on
        first sight (open tenancy; pre-:meth:`configure` to close it)."""
        state = self._tenants.get(tenant)
        if state is None:
            state = self._make_state(self.default)
            self._tenants[tenant] = state
        return state

    def _make_state(self, config: TenantConfig) -> TenantState:
        return TenantState(config=config, bucket=self._make_bucket(config))

    @staticmethod
    def _make_bucket(config: TenantConfig) -> Optional[TokenBucket]:
        if config.rate_rps is None:
            return None
        # class-weighted refill: the configured rate is the standard-class
        # rate; rt refills faster, batch slower (CLASS_RATE_WEIGHTS).  The
        # burst capacity is NOT scaled — how much a tenant may burst is a
        # separate knob from how fast the budget replenishes.
        rate = config.rate_rps * class_rate_weight(config.priority)
        burst = (config.burst if config.burst is not None
                 else max(1.0, config.rate_rps))
        return TokenBucket(rate, burst)

    # ----------------------------------------------------------- decisions

    def admit(
        self,
        tenant: str,
        *,
        vectors: int = 1,
        deadline_s: Optional[float] = None,
        estimate_s: Optional[float] = None,
        queue_depth: Optional[int] = None,
        now: Optional[float] = None,
    ) -> TenantState:
        """Admit one request of ``vectors`` RHS or raise RequestRejected.

        The checks run cheapest-first and spend nothing until all pass: a
        request the pending bound rejects must not drain bucket tokens.

        Args:
          tenant: tenant identity (created on first sight).
          vectors: batch width B (token cost; pending cost is 1 request).
          deadline_s: the request's SLO latency budget, if any.
          estimate_s: current service-time estimate for this work (the
            service's observed EWMA); feasibility is skipped when unknown.
          queue_depth: vectors already queued ahead of this request.  The
            serving layer passes the **class-aware** count
            (:meth:`MicroBatcher.pending_ahead`): only equal-or-higher
            priority vectors wait ahead of this tenant's class, since
            lower classes will be preempted behind it.  With an estimate,
            expected completion is modeled as
            ``(queue_depth + 1) * estimate_s`` and a deadline below that
            (x safety) sheds with ``queue_wait_infeasible`` — bare service
            feasibility alone would admit into an already-doomed backlog.
          now: injected monotonic time (tests/replay).

        Returns:
          The TenantState, with ``pending``/counters already updated.

        Raises:
          RequestRejected: with ``reason`` set to the failed budget.
        """
        state = self.state(tenant)
        cfg = state.config
        if deadline_s is not None:
            if deadline_s <= 0:
                self._reject(state, tenant, "deadline_infeasible",
                             f"deadline {deadline_s}s has already passed")
            if estimate_s is not None and deadline_s < estimate_s * self.safety:
                self._reject(
                    state, tenant, "deadline_infeasible",
                    f"deadline {deadline_s:.2e}s < estimated service "
                    f"{estimate_s:.2e}s x safety {self.safety}",
                )
            if estimate_s is not None and queue_depth:
                expected = (queue_depth + 1) * estimate_s
                if deadline_s < expected * self.safety:
                    self._reject(
                        state, tenant, "queue_wait_infeasible",
                        f"deadline {deadline_s:.2e}s < expected wait+service "
                        f"({queue_depth} ahead + 1) x {estimate_s:.2e}s "
                        f"x safety {self.safety}",
                    )
        if cfg.max_pending is not None and state.pending >= cfg.max_pending:
            self._reject(state, tenant, "queue_full",
                         f"{state.pending} >= max_pending {cfg.max_pending}")
        if state.bucket is not None:
            admitted = state.bucket.try_take(vectors, now)
            if self.metrics is not None:
                self.metrics.gauge("serve.tokens.remaining",
                                   tenant=tenant).set(state.bucket.tokens)
            if not admitted:
                self._reject(state, tenant, "rate_limited",
                             f"bucket empty for {vectors} vector(s)")
        state.pending += 1
        state.accepted += 1
        state.vectors += vectors
        return state

    def _reject(self, state: TenantState, tenant: str, reason: str,
                detail: str) -> None:
        state.rejected[reason] += 1
        if self.metrics is not None:
            self.metrics.counter("serve.shed", reason=reason).inc()
            self.metrics.counter("serve.shed", reason=reason,
                                 cls=state.config.priority).inc()
        raise RequestRejected(tenant, reason, detail)

    def reject_all(self, tenant: str, reason: str = "shutdown") -> None:
        """Count an out-of-band rejection (e.g. service closed)."""
        state = self.state(tenant)
        state.rejected[reason] += 1
        if self.metrics is not None:
            self.metrics.counter("serve.shed", reason=reason).inc()
            self.metrics.counter("serve.shed", reason=reason,
                                 cls=state.config.priority).inc()

    def finished(self, tenant: str) -> None:
        """A previously admitted request resolved (success or failure)."""
        state = self.state(tenant)
        state.pending = max(0, state.pending - 1)
        state.completed += 1

    # ----------------------------------------------------------- reporting

    def snapshot(self) -> Dict[str, dict]:
        """{tenant: counters} for the SLO report."""
        out = {}
        for tenant, s in self._tenants.items():
            out[tenant] = {
                "priority": s.config.priority,
                "accepted": s.accepted,
                "completed": s.completed,
                "pending": s.pending,
                "vectors": s.vectors,
                "rejected": dict(s.rejected),
                "rejected_total": s.rejected_total,
            }
        return out
