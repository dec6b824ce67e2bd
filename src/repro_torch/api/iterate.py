"""On-device iterative-solver loops — x stays resident across SpMVs.

Counterpart of ``repro/api/iterate.py``, with the same names.  SpMV's real
consumers are iterative solvers (CG, power iteration, PageRank,
Jacobi/Richardson sweeps) where the vector feeds straight back into the
next multiply.  ``Executor.__call__`` round-trips y through the host every
step; :func:`run_iterate` instead runs the whole solver loop — k SpMVs plus
the per-step combine — as a Python loop over tensors on the executor's
device, so x, the carry and ``b`` / ``diag`` never leave the device
between load and retrieve.  Under ``impl="cuda"`` each step is one launch
of the COO or block kernel (one part-axis launch for a partitioned plan)
followed by the combine's torch operations, all on the calling thread's
stream.

Two loop modes, as in the reference:

  * **steps mode** (``steps=k``) — exactly k steps, with no host
    synchronization in between.  For the linear combines the result is
    bit-identical to k host-side ``exe(x)`` calls.
  * **tol mode** (``tol=...``) — the reference's ``while_loop`` schedule:
    ``k < max_steps and residual > tol`` is tested before each chunk of
    ``min(check_every, max_steps - k)`` steps.  Testing it reads the
    residual to the host, the one synchronization per chunk (the
    counterpart of the ``while_loop`` condition); ``max_steps`` bounds
    the loop and reports ``converged=False`` rather than hanging.

Built-in combines (:func:`make_combine`): ``plain`` (x' = y), ``power``
(normalize), ``richardson`` / ``jacobi`` (damped residual correction toward
``A x = b``), ``cg`` (conjugate gradients on SPD systems), plus any
user-supplied ``f(x, y) -> x_next`` callable as the escape hatch.  Each
combine is written as one torch operation per ``jnp`` operation of the
reference, so no two roundings are contracted into one (an FMA would break
the linear combines' bit-identity with the host loop).

The loop is cached on the executor per (combine, mode); ``b`` / ``diag`` /
``omega`` / ``tol`` enter as runtime arguments, so re-solving with a new
right-hand side reuses it.  Nothing is compiled: ``compiled=True`` marks the
first session of a key, as the reference marks the session that traced its
loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core import formats as F
from ..core.streams import wait

__all__ = ["IterateResult", "Combine", "make_combine", "run_iterate",
           "COMBINES"]

_TINY = 1e-30  # normalization floor: keeps power iteration NaN-free on y=0


@dataclass(frozen=True)
class IterateResult:
    """Outcome of one on-device solver session."""

    x: np.ndarray  # the solution / final iterate (host)
    steps: int  # SpMV steps actually executed on device
    converged: bool  # tol given and final residual <= tol
    residual: float  # final residual (combine-specific norm)
    load_s: float  # place x0 (+ b/diag params) on device
    kernel_s: float  # the solver loop
    retrieve_s: float  # fetch x + scalars back to host
    compiled: bool = False  # first session of this loop (cold start)

    @property
    def seconds(self) -> float:
        """Wall-clock time-to-solution (all three phases)."""
        return self.load_s + self.kernel_s + self.retrieve_s

    @property
    def per_iter_s(self) -> float:
        """Loop seconds per executed SpMV step."""
        return self.kernel_s / max(1, self.steps)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of a vector, as a 0-d tensor on v's device, in
    v's dtype (the reference's ``.astype(y.dtype)``; integer vectors are
    measured in float32, as jnp does)."""
    return torch.linalg.vector_norm(v if v.is_floating_point() else v.float())


def _inf(like: torch.Tensor) -> torch.Tensor:
    """A 0-d inf in ``like``'s dtype (float32 for integer dtypes, which
    cannot hold it), filled on its device (no host copy)."""
    dtype = like.dtype if like.is_floating_point() else torch.float32
    return torch.full((), float("inf"), dtype=dtype, device=like.device)


class Combine:
    """Per-step state update of a solver loop (tensor operations).

    The loop calls ``vector(carry)`` to pick what feeds the SpMV, applies
    the executor, then ``step(carry, y, params)`` to advance.  ``carry`` is
    a dict carrying at least ``x`` (the current iterate) and ``res`` (the
    residual the tol loop tests).  ``linear=True`` marks combines whose
    step is an affine map of the state — exactly the ones for which k
    steps must be bit-identical to k host-side calls.
    """

    name = "combine"
    linear = False
    needs_b = False

    def init(self, x0, params, apply) -> dict:
        return {"x": x0, "res": _inf(x0)}

    def vector(self, carry):
        return carry["x"]

    def step(self, carry, y, params) -> dict:
        raise NotImplementedError

    def solution(self, carry):
        return carry["x"]

    def residual(self, carry):
        return carry["res"]


class PlainCombine(Combine):
    """x' = y — the raw SpMV recurrence (parity anchor; Markov chains)."""

    name = "plain"
    linear = True

    def step(self, carry, y, params):
        return {"x": y, "res": _norm(y - carry["x"])}


class PowerCombine(Combine):
    """Power iteration: x' = y / ||y||; residual = ||x' - x||."""

    name = "power"

    def step(self, carry, y, params):
        nrm = _norm(y)
        x_new = y / torch.clamp_min(nrm, _TINY)
        return {"x": x_new, "res": _norm(x_new - carry["x"])}


class RichardsonCombine(Combine):
    """Damped Richardson for A x = b: x' = x + omega (b - y); res = ||b - y||."""

    name = "richardson"
    linear = True
    needs_b = True

    def step(self, carry, y, params):
        r = params["b"] - y
        x_new = carry["x"] + params["omega"] * r
        return {"x": x_new, "res": _norm(r)}


class JacobiCombine(Combine):
    """Jacobi sweep for A x = b: x' = x + (b - y) / diag(A)."""

    name = "jacobi"
    linear = True
    needs_b = True

    def step(self, carry, y, params):
        r = params["b"] - y
        x_new = carry["x"] + r / params["diag"]
        return {"x": x_new, "res": _norm(r)}


class CGCombine(Combine):
    """Conjugate gradients on SPD A x = b; the SpMV input is the search
    direction p, not x — ``init`` spends one extra multiply on r0.
    (``torch.dot`` stands for the reference's ``jnp.vdot(...).real``: the
    vectors are real.)"""

    name = "cg"
    needs_b = True

    def init(self, x0, params, apply):
        r = params["b"] - apply(x0)
        rs = torch.dot(r, r)
        return {"x": x0, "r": r, "p": r, "rs": rs, "res": torch.sqrt(rs)}

    def vector(self, carry):
        return carry["p"]

    def step(self, carry, y, params):
        x, r, p, rs = carry["x"], carry["r"], carry["p"], carry["rs"]
        denom = torch.dot(p, y)
        alpha = rs / torch.where(denom == 0, _TINY, denom)
        x_new = x + alpha * p
        r_new = r - alpha * y
        rs_new = torch.dot(r_new, r_new)
        beta = rs_new / torch.where(rs == 0, _TINY, rs)
        p_new = r_new + beta * p
        return {"x": x_new, "r": r_new, "p": p_new, "rs": rs_new,
                "res": torch.sqrt(rs_new)}


class CallableCombine(Combine):
    """Escape hatch: any ``f(x, y) -> x_next`` (residual = ||x' - x||)."""

    name = "callable"

    def __init__(self, fn: Callable):
        self.fn = fn

    def step(self, carry, y, params):
        x_new = self.fn(carry["x"], y)
        return {"x": x_new, "res": _norm(x_new - carry["x"])}


COMBINES = {
    "plain": PlainCombine,
    "power": PowerCombine,
    "richardson": RichardsonCombine,
    "jacobi": JacobiCombine,
    "cg": CGCombine,
}


def make_combine(combine: Union[str, Callable]) -> Combine:
    """Resolve a combine spec: a builtin name or an ``f(x, y)`` callable."""
    if callable(combine):
        return CallableCombine(combine)
    cls = COMBINES.get(combine)
    if cls is None:
        raise ValueError(
            f"unknown combine {combine!r}: one of {sorted(COMBINES)} "
            "or a callable f(x, y) -> x_next"
        )
    return cls()


def _combine_key(combine: Union[str, Callable]) -> object:
    return combine if isinstance(combine, str) else id(combine)


def _build_params(comb: Combine, n: int, dtype: torch.dtype, b, diag,
                  omega, device) -> dict:
    """Runtime parameters for the loop, validated on the host and placed on
    ``device`` (shipped per call, so a new right-hand side reuses the
    cached loop)."""
    params = {"omega": torch.tensor(float(omega), dtype=dtype, device=device)}
    if comb.needs_b:
        if b is None:
            raise ValueError(f"combine={comb.name!r} needs b (right-hand side)")
        b = F.to_tensor(b, dtype)
        if tuple(b.shape) != (n,):
            raise ValueError(f"b must have shape ({n},); got {tuple(b.shape)}")
        params["b"] = b.to(device)
    if comb.name == "jacobi":
        if diag is None:
            raise ValueError("combine='jacobi' needs diag (the matrix diagonal)")
        diag = F.to_tensor(diag, dtype)
        if tuple(diag.shape) != (n,):
            raise ValueError(f"diag must have shape ({n},); got "
                             f"{tuple(diag.shape)}")
        if bool((diag == 0).any()):
            raise ValueError("combine='jacobi' needs a zero-free diagonal")
        params["diag"] = diag.to(device)
    return params


def run_iterate(
    executor,
    apply: Callable,
    x0,
    *,
    steps: Optional[int] = None,
    tol: Optional[float] = None,
    combine: Union[str, Callable] = "plain",
    b=None,
    diag=None,
    omega: float = 1.0,
    max_steps: int = 1000,
    check_every: int = 8,
) -> IterateResult:
    """Drive ``apply`` (device y = A @ v) as a solver loop on the device.

    Shared by every executor type: ``apply`` encapsulates the backend
    (single-device kernel program, or pad -> partitioned program -> row
    assembly on the device); the loop, combine and caching logic live here
    once.  The loop is cached on ``executor._iterate_loops`` keyed by
    (combine, mode).  Runs on the current stream; the executor calls it on
    the calling thread's own stream.

    Args:
      executor: the owning Executor (supplies dtype/cols validation via
        ``_check_x``, the device, and hosts the loop cache).
      apply: device function, logical (n,) -> (n,) in the matrix dtype.
      x0: (n,) start vector (host array or tensor).
      steps: run exactly this many steps.  Exclusive with ``tol``.
      tol: run until ``residual <= tol`` (residual read to the host every
        ``check_every`` steps), or until ``max_steps``.
      combine: builtin name (``plain`` / ``power`` / ``richardson`` /
        ``jacobi`` / ``cg``) or a callable ``f(x, y) -> x_next``.
      b: right-hand side for richardson/jacobi/cg.
      diag: matrix diagonal for jacobi.
      omega: richardson damping factor.
      max_steps: tol-mode step bound — the never-hang guard.
      check_every: tol-mode steps between residual checks.

    Returns:
      :class:`IterateResult` (x on host, steps executed, convergence,
      per-phase seconds).

    Raises:
      ValueError: for both/neither of steps and tol, a non-square executor
        (callers check), bad combine/params, or a batched x0.
    """
    if (steps is None) == (tol is None):
        raise ValueError("iterate needs exactly one of steps= or tol=")
    if steps is not None and steps < 1:
        raise ValueError(f"steps must be >= 1; got {steps}")
    if tol is not None and (tol <= 0 or max_steps < 1 or check_every < 1):
        raise ValueError("tol mode needs tol > 0, max_steps >= 1 and "
                         "check_every >= 1")
    n, dtype = executor._iterate_shape()
    x0 = executor._check_x(x0, n, dtype)
    if x0.ndim != 1:
        raise ValueError(f"iterate takes a single (n,) start vector; "
                         f"got shape {tuple(x0.shape)}")
    comb = make_combine(combine)
    device = executor.device

    t0 = time.perf_counter()
    params = _build_params(comb, n, dtype, b, diag, omega, device)
    x0_dev = x0.to(device).contiguous()
    wait(device)
    t1 = time.perf_counter()

    cache = getattr(executor, "_iterate_loops", None)
    if cache is None:
        cache = executor._iterate_loops = {}
    mode = ("steps", steps) if steps is not None else \
        ("tol", max_steps, check_every)
    key = (_combine_key(combine), mode)
    loop = cache.get(key)
    cold = loop is None
    if cold:
        loop = _build_loop(comb, steps, max_steps, check_every)
        cache[key] = loop

    carry, k = loop(apply, x0_dev, params,
                    None if tol is None else float(tol))
    x = comb.solution(carry)
    wait(device)
    t2 = time.perf_counter()
    residual = float(comb.residual(carry))
    x_host = _to_host(x)
    t3 = time.perf_counter()

    return IterateResult(
        x=x_host,
        steps=k,
        converged=bool(tol is not None and residual <= tol),
        residual=residual,
        load_s=t1 - t0,
        kernel_s=t2 - t1,
        retrieve_s=t3 - t2,
        compiled=cold,
    )


def _build_loop(comb: Combine, steps: Optional[int], max_steps: int,
                check_every: int) -> Callable:
    """The solver loop: (apply, x0_dev, params, tol) -> (carry, steps_run).

    Steps mode enqueues every step without reading the device.  Tol mode
    reads the residual once per test of the reference's ``while_loop``
    condition, i.e. before each chunk of at most ``check_every`` steps.
    """

    def one_step(apply, carry, params):
        y = apply(comb.vector(carry))
        return comb.step(carry, y, params)

    if steps is not None:

        def loop_steps(apply, x0_dev, params, tol):
            carry = comb.init(x0_dev, params, apply)
            for _ in range(steps):
                carry = one_step(apply, carry, params)
            return carry, steps

        return loop_steps

    def loop_tol(apply, x0_dev, params, tol):
        carry = comb.init(x0_dev, params, apply)
        k = 0
        while k < max_steps and float(comb.residual(carry)) > tol:
            # chunked residual check: advance up to check_every steps before
            # the next test; the cap keeps the total under max_steps exactly
            n_inner = min(check_every, max_steps - k)
            for _ in range(n_inner):
                carry = one_step(apply, carry, params)
            k += n_inner
        return carry, k

    return loop_tol


def _to_host(x: torch.Tensor) -> np.ndarray:
    from .executor import to_host  # executor imports this module

    return to_host(x)
