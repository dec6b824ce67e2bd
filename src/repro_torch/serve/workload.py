"""Seeded synthetic serving traffic — Zipfian popularity, bursty arrivals.

Counterpart of ``repro/serve/workload.py``: equal specs give the JAX
package's traces and payloads, bit for bit.

Real SpMV serving traffic (graph queries, web/social ranking — the
scale-free workloads SparseP's Table 4 keys on) is skewed twice over: a few
matrices absorb most requests (Zipf's law over popularity), and arrivals
cluster into bursts rather than a clean Poisson stream.  Both skews are
exactly what the serving layer's knobs exist for — plan caching pays off on
the popular head, micro-batching on the bursts, admission control on the
overload — so the generator reproduces them deterministically:

  * **matrix popularity** — Zipfian over the registered names
    (``P(rank r) ∝ r^-alpha``); ``zipf_alpha=0`` degrades to uniform.
  * **arrivals** — Poisson (exponential gaps at ``rate_rps``), or a
    two-state Markov-modulated process (``arrivals="bursty"``): a burst
    state arriving ``burst_factor`` times faster, entered/left with seeded
    coin flips — the ALPHA-PIM-style irregular traffic shape.
  * **request mix** — mostly single vectors with a tail of explicit
    (cols, B) batches (``batch_mix``), and an optional ``infeasible_frac``
    of requests stamped with an already-expired deadline: correct serving
    *rejects* these (load shedding), it never serves them late.

Every request carries its own ``seed``; :func:`request_vector` rebuilds the
payload on demand, so a trace is a few KB however long the replay.  With
``integer_values=True`` payloads are small integers — float32 SpMV over
small-integer values is exact in any summation order, which is what lets
the replayer assert *bit-equality* against the dense oracle end to end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .admission import TenantConfig, class_rank

__all__ = [
    "ServeRequest",
    "WorkloadSpec",
    "generate_trace",
    "request_vector",
    "popularity",
    "describe_trace",
    "tenant_configs",
]


@dataclass(frozen=True)
class ServeRequest:
    """One request of a replayable trace (payload rebuilt from ``seed``)."""

    t: float  # arrival offset from trace start, seconds
    tenant: str
    name: str  # matrix name (unscoped; the service resolves per tenant)
    batch: int  # 1 => single vector; B>1 => explicit (cols, B) request
    seed: int  # per-request payload seed (request_vector rebuilds x)
    deadline_s: Optional[float] = None  # SLO budget; None => best effort
    infeasible: bool = False  # stamped unmeetable: MUST be shed, not served
    solve_steps: Optional[int] = None  # a solver session of this many steps
    solve_combine: str = "power"  # session combine (solver sessions only)

    @property
    def is_solve(self) -> bool:
        return self.solve_steps is not None


@dataclass(frozen=True)
class WorkloadSpec:
    """Seeded description of a synthetic serving workload.

    Attributes:
      names: matrix names, most popular first (Zipf rank order).
      tenants: tenant identities, assigned per request (seeded uniform).
      n_requests: trace length.
      seed: the one RNG seed — equal specs generate identical traces.
      zipf_alpha: popularity skew (0 = uniform, ~1 = classic Zipf).
      rate_rps: mean arrival rate, requests/s.
      arrivals: "poisson" | "bursty" (two-state modulated Poisson).
      burst_factor: bursty only — rate multiplier inside a burst.
      burst_enter/burst_exit: bursty only — per-request transition
        probabilities between the calm and burst states.
      batch_mix: {batch_width: weight}; width 1 submits through the
        micro-batcher, widths > 1 are explicit SpMM requests.
      deadline_s: SLO stamped on every request (None = best effort).
      infeasible_frac: fraction of requests stamped with an expired
        deadline (0.0s) and ``infeasible=True`` — the shedding probe.
      integer_values: integer payloads for bit-exact oracle comparison.
      solve_frac: fraction of (single-vector) requests that are solver
        sessions instead of one-shot multiplies — the ALPHA-PIM-style
        graph-analytics mix (power iteration over the registered graph).
        ``0.0`` (the default) draws nothing extra, so pre-solver specs
        generate bit-identical traces.
      solve_steps: step count stamped on each solver session.
      solve_combine: combine stamped on each solver session (``power``
        needs no right-hand side, so any registered square matrix serves).
      tenant_classes: optional {tenant: SLO class} mapping (docs/slo.md).
        Purely descriptive — it consumes no randomness, so adding it to an
        existing spec keeps the generated trace bit-identical; feed it to
        :func:`tenant_configs` to build the matching service tenants.
    """

    names: Tuple[str, ...]
    tenants: Tuple[str, ...] = ("tenant-a", "tenant-b")
    n_requests: int = 100
    seed: int = 0
    zipf_alpha: float = 1.1
    rate_rps: float = 500.0
    arrivals: str = "poisson"
    burst_factor: float = 8.0
    burst_enter: float = 0.1
    burst_exit: float = 0.3
    batch_mix: Dict[int, float] = field(
        default_factory=lambda: {1: 0.85, 4: 0.1, 8: 0.05}
    )
    deadline_s: Optional[float] = None
    infeasible_frac: float = 0.0
    integer_values: bool = False
    solve_frac: float = 0.0
    solve_steps: int = 16
    solve_combine: str = "power"
    tenant_classes: Optional[Dict[str, str]] = None

    def __post_init__(self):
        if self.tenant_classes:
            for tenant, cls in self.tenant_classes.items():
                class_rank(cls)  # raise early on an unknown class
                if tenant not in self.tenants:
                    raise ValueError(
                        f"tenant_classes names unknown tenant {tenant!r}"
                    )
        if not self.names:
            raise ValueError("workload needs at least one matrix name")
        if not self.tenants:
            raise ValueError("workload needs at least one tenant")
        if self.arrivals not in ("poisson", "bursty"):
            raise ValueError(
                f"unknown arrivals {self.arrivals!r}: 'poisson' or 'bursty'"
            )
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if not 0.0 <= self.infeasible_frac <= 1.0:
            raise ValueError("infeasible_frac must be in [0, 1]")
        if not 0.0 <= self.solve_frac <= 1.0:
            raise ValueError("solve_frac must be in [0, 1]")
        if self.solve_steps < 1:
            raise ValueError(f"solve_steps must be >= 1, got {self.solve_steps}")
        if not self.batch_mix or any(w < 0 for w in self.batch_mix.values()) \
                or sum(self.batch_mix.values()) <= 0:
            raise ValueError("batch_mix needs non-negative weights summing > 0")


def _popularity(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def generate_trace(spec: WorkloadSpec) -> list:
    """Deterministically expand ``spec`` into a list of ServeRequests.

    All randomness flows from one ``default_rng(spec.seed)`` in a fixed
    draw order, so equal specs produce identical traces — the property the
    perf gate and the determinism test lean on.

    Returns:
      ServeRequests sorted by arrival offset ``t`` (ascending).
    """
    rng = np.random.default_rng(spec.seed)
    pop = _popularity(len(spec.names), spec.zipf_alpha)
    widths = np.array(sorted(spec.batch_mix), dtype=np.int64)
    mix = np.array([spec.batch_mix[int(b)] for b in widths], dtype=np.float64)
    mix = mix / mix.sum()

    trace = []
    t = 0.0
    in_burst = False
    for _ in range(spec.n_requests):
        if spec.arrivals == "bursty":
            flip = rng.random()
            if in_burst and flip < spec.burst_exit:
                in_burst = False
            elif not in_burst and flip < spec.burst_enter:
                in_burst = True
            rate = spec.rate_rps * (spec.burst_factor if in_burst else 1.0)
        else:
            rate = spec.rate_rps
        t += float(rng.exponential(1.0 / rate))
        name = spec.names[int(rng.choice(len(spec.names), p=pop))]
        tenant = spec.tenants[int(rng.integers(len(spec.tenants)))]
        batch = int(widths[int(rng.choice(len(widths), p=mix))])
        seed = int(rng.integers(0, 2**31 - 1))
        infeasible = bool(spec.infeasible_frac
                          and rng.random() < spec.infeasible_frac)
        deadline = 0.0 if infeasible else spec.deadline_s
        # guarded draw: solve_frac == 0 consumes no randomness, keeping
        # pre-solver specs' traces bit-identical (the determinism the perf
        # gates replay against)
        solve_steps, solve_combine = None, "power"
        if spec.solve_frac and rng.random() < spec.solve_frac:
            solve_steps = spec.solve_steps
            solve_combine = spec.solve_combine
            batch = 1  # a session starts from one (n,) vector
        trace.append(ServeRequest(
            t=t, tenant=tenant, name=name, batch=batch, seed=seed,
            deadline_s=deadline, infeasible=infeasible,
            solve_steps=solve_steps, solve_combine=solve_combine,
        ))
    return trace


def request_vector(req: ServeRequest, cols: int, dtype=np.float32,
                   integer: bool = False) -> np.ndarray:
    """Rebuild the request's payload from its seed.

    Args:
      req: the trace entry.
      cols: matrix column count (payload length).
      dtype: payload dtype.
      integer: small-integer values in [-3, 3] — float32-exact in any
        summation order, enabling bit-equality against the dense oracle.

    Returns:
      (cols,) for ``req.batch == 1``, else (cols, batch).
    """
    rng = np.random.default_rng(req.seed)
    shape = (cols,) if req.batch == 1 else (cols, req.batch)
    if integer:
        x = rng.integers(-3, 4, size=shape)
    else:
        x = rng.standard_normal(shape)
    return x.astype(dtype)


def tenant_configs(spec: WorkloadSpec, **config_kwargs) -> Dict[str, "TenantConfig"]:
    """Build the service's ``tenants`` mapping from a spec's SLO classes.

    Every tenant in ``spec.tenants`` gets one :class:`TenantConfig` with
    ``priority`` taken from ``spec.tenant_classes`` (default ``standard``)
    and any remaining budget knobs (``max_pending`` / ``rate_rps`` /
    ``burst``) from ``config_kwargs``, applied uniformly:

        service = AsyncSpmvService(engine,
                                   tenants=tenant_configs(spec,
                                                          max_pending=128))
    """
    classes = spec.tenant_classes or {}
    return {
        tenant: TenantConfig(priority=classes.get(tenant, "standard"),
                             **config_kwargs)
        for tenant in dict.fromkeys(spec.tenants)
    }


def popularity(spec: WorkloadSpec) -> Dict[str, float]:
    """The Zipfian name->probability map a spec samples from (introspection)."""
    return dict(zip(spec.names, _popularity(len(spec.names), spec.zipf_alpha)))


def describe_trace(trace: Sequence[ServeRequest]) -> dict:
    """Summary counts for logging: span, per-name/tenant shares, widths."""
    if not trace:
        return {"requests": 0}
    names: Dict[str, int] = {}
    tenants: Dict[str, int] = {}
    widths: Dict[int, int] = {}
    infeasible = 0
    solves = 0
    for r in trace:
        names[r.name] = names.get(r.name, 0) + 1
        tenants[r.tenant] = tenants.get(r.tenant, 0) + 1
        widths[r.batch] = widths.get(r.batch, 0) + 1
        infeasible += int(r.infeasible)
        solves += int(r.is_solve)
    return {
        "requests": len(trace),
        "span_s": trace[-1].t - trace[0].t,
        "names": names,
        "tenants": tenants,
        "widths": widths,
        "infeasible": infeasible,
        "solves": solves,
    }
