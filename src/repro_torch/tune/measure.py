"""Measurer — wall-clock truth for candidate ExecutionPlans.

Counterpart of ``repro/tune/measure.py``.  The analytic model in
:mod:`repro_torch.core.adaptive` ranks schemes; this module replaces the
ranking with measurements: compile each candidate, run it on
representative vectors with warmup, and keep a trimmed mean so one GC pause
or laggard sample cannot crown the wrong plan.  Distributed candidates are
additionally timed per phase (place / run_raw / assemble — the paper's
Fig.-4 load / kernel / retrieve split, the same decomposition the engine's
Telemetry records), so a tuning log explains *why* a plan won, not just
that it did.

``mean_s`` keeps the reference's definition: the wall time of ``exe(x)``
with host rows returned, so it holds both copies as well as the kernel.
A measurement runs on the calling thread's own CUDA stream
(:mod:`repro_torch.core.streams`), and each phase of a distributed plan
ends in a wait on that stream alone, so the kernel phase is the card's
time for this candidate and not the time to enqueue it, even while other
threads serve.

:class:`FakeMeasurer` is the deterministic stand-in for tests and CI: times
derive from a stable hash of the candidate identity (or an explicit cost
table), never from the wall clock, so ``scheme="tune"`` is reproducible
under it.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..api.executor import _np_bfloat16
from ..core.formats import dtype_name
from ..core.streams import on_thread_stream

__all__ = ["Measurement", "Measurer", "FakeMeasurer"]


@dataclass(frozen=True)
class Measurement:
    """One candidate's measured behaviour (all times in seconds)."""

    scheme_id: str
    impl: str
    grid: tuple
    fmt: str
    mean_s: float  # trimmed mean of the timed calls
    times_s: tuple  # every timed call, untrimmed
    compile_s: float  # plan.compile() wall time (partition + place + build)
    phases: dict  # mean load/kernel/retrieve seconds (distributed plans)

    def describe(self) -> str:
        head = (
            f"{self.scheme_id} impl={self.impl} grid={self.grid}: "
            f"{self.mean_s * 1e6:.1f}us/call (compile {self.compile_s:.3f}s)"
        )
        if self.phases:
            split = ", ".join(
                f"{k}={v * 1e6:.1f}us" for k, v in self.phases.items()
            )
            head += f" [{split}]"
        return head


def _trimmed_mean(times: list, trim: int) -> float:
    ordered = sorted(times)
    if trim and len(ordered) > 2 * trim:
        ordered = ordered[trim:-trim]
    return float(np.mean(ordered))


@dataclass
class Measurer:
    """Compile-and-time harness for ExecutionPlans.

    Attributes:
      warmup: untimed calls before measuring (absorbs first-touch costs);
        0 is honored — the first timed call then includes cold-dispatch cost.
      iters: timed calls per candidate (at least one always runs).
      trim: samples dropped from each end before the mean (when iters allow).
      seed: RNG seed for the representative vectors.
      clock: injectable time source (tests); defaults to perf_counter.
    """

    warmup: int = 2
    iters: int = 5
    trim: int = 1
    seed: int = 0
    clock: Callable[[], float] = field(default=time.perf_counter)

    def representative(self, matrix, batch: Optional[int] = None):
        """A representative input: standard-normal x of the matrix's dtype,
        shape (cols,) or (cols, batch) — the reference's draws.

        A bfloat16 matrix gets an ``ml_dtypes.bfloat16`` array where
        ml_dtypes imports (the reference's bits) and otherwise a bfloat16
        tensor, as ``to_host`` returns bfloat16 results.
        """
        rng = np.random.default_rng(self.seed)
        shape = (matrix.cols,) if not batch or batch == 1 else (matrix.cols, batch)
        x = rng.standard_normal(shape)
        if matrix.dtype == torch.bfloat16:
            bf16 = _np_bfloat16()
            if bf16 is None:
                return torch.from_numpy(x).to(torch.bfloat16)
            return x.astype(bf16)
        return x.astype(dtype_name(matrix.dtype))

    def measure(self, plan, x) -> Measurement:
        """Compile ``plan`` and time ``exe(x)``; releases the executor after.

        Args:
          plan: an ExecutionPlan (single-device or distributed).
          x: the input, (cols,) or (cols, B), dtype-compatible: a host
            array or a tensor (on the host or on the plan's device).

        Returns:
          The Measurement (phase split populated for distributed plans).

        Raises:
          Whatever ``plan.compile()`` or the executor raise — the tuner
          drops a raising candidate, except a ``cuda`` one on a CUDA
          device: a kernel fault, which it re-raises.
        """
        clock = self.clock
        with on_thread_stream(plan.device):
            t0 = clock()
            exe = plan.compile()
            compile_s = clock() - t0
            try:
                return self._time(plan, exe, x, compile_s)
            finally:
                exe.release()

    def _time(self, plan, exe, x, compile_s: float) -> Measurement:
        clock = self.clock
        distributed = plan.is_distributed
        for _ in range(max(0, self.warmup)):
            exe(x)
        times, phases = [], {"load": [], "kernel": [], "retrieve": []}
        for _ in range(max(1, self.iters)):
            if distributed:
                t0 = clock()
                xs = exe.place(x)  # each phase ends in a wait on this stream
                t1 = clock()
                raw = exe.run_raw(xs)
                t2 = clock()
                exe.assemble(raw)
                t3 = clock()
                phases["load"].append(t1 - t0)
                phases["kernel"].append(t2 - t1)
                phases["retrieve"].append(t3 - t2)
                times.append(t3 - t0)
            else:
                t0 = clock()
                exe(x)  # returns host rows: waits for this stream's work
                times.append(clock() - t0)
        return Measurement(
            scheme_id=plan.scheme_id,
            impl=plan.impl,
            grid=plan.grid,
            fmt=plan.fmt,
            mean_s=_trimmed_mean(times, self.trim),
            times_s=tuple(times),
            compile_s=compile_s,
            phases=(
                {k: float(np.mean(v)) for k, v in phases.items()}
                if distributed
                else {}
            ),
        )


class FakeMeasurer(Measurer):
    """Deterministic Measurer for tests and CI smoke runs.

    Never compiles or runs anything.  The "measured" time of a candidate is
    looked up in ``costs`` by scheme_id (or ``scheme_id|impl``), falling
    back to a stable pseudo-time hashed from (seed, scheme_id, impl, grid) —
    the reference's token and hash, so the same strings give the same
    float — so repeated tunes of the same matrix on the same pool pick the
    same winner, and a test can force any ranking it wants via ``costs``.
    """

    def __init__(self, costs: Optional[Dict[str, float]] = None, seed: int = 0):
        super().__init__(warmup=0, iters=1, trim=0, seed=seed)
        self.costs = dict(costs or {})
        self.calls: list = []  # candidate keys, in measurement order

    def _fake_time(self, plan) -> float:
        for key in (f"{plan.scheme_id}|{plan.impl}", plan.scheme_id):
            if key in self.costs:
                return float(self.costs[key])
        token = f"{self.seed}|{plan.scheme_id}|{plan.impl}|{plan.grid}"
        digest = hashlib.sha256(token.encode()).digest()
        frac = int.from_bytes(digest[:8], "big") / 2**64
        return 1e-3 * (1.0 + frac)  # deterministic 1-2ms band

    def measure(self, plan, x=None) -> Measurement:
        t = self._fake_time(plan)
        self.calls.append(f"{plan.scheme_id}|{plan.impl}")
        return Measurement(
            scheme_id=plan.scheme_id,
            impl=plan.impl,
            grid=plan.grid,
            fmt=plan.fmt,
            mean_s=t,
            times_s=(t,),
            compile_s=0.0,
            phases={},
        )
