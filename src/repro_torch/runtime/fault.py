"""Fault tolerance + straggler mitigation for thousand-node runs.

Counterpart of ``repro/runtime/fault.py``, copied: it is plain Python and
numpy, and the port imports nothing of the JAX package.

On a real multi-pod deployment the failure domain is a host (8 chips); JAX
surfaces failures as a poisoned runtime that must be restarted from a
checkpoint.  This module implements the *control plane* for that loop, kept
hardware-agnostic so the same logic drives the CPU simulation in tests and a
real cluster launcher:

  * ``HealthMonitor`` — per-step heartbeats; flags missing heartbeats
    (dead host) and step-time outliers (stragglers, flagged at
    median + k*MAD — robust to the step-time distribution).
  * ``RestartPolicy`` — on failure: reload latest checkpoint; if the same
    step fails ``max_retries`` times, escalate to ``rescale`` (drop the bad
    hosts, continue on a smaller mesh — runtime/elastic.py).
  * straggler mitigation at the data level: slow hosts get their per-step
    microbatch count reduced (gradient contributions stay unbiased because
    the loss is re-weighted by actual tokens — see launch/train.py).

tests/test_torch_train_loop.py drives failure injection through these
classes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["HealthMonitor", "RestartPolicy", "FaultEvent"]


@dataclass
class FaultEvent:
    kind: str  # "dead" | "straggler"
    host: int
    step: int
    detail: str = ""


@dataclass
class HealthMonitor:
    n_hosts: int
    heartbeat_timeout_s: float = 60.0
    straggler_mad_k: float = 5.0
    min_history: int = 8
    _last_beat: dict = field(default_factory=dict)
    _step_times: dict = field(default_factory=dict)

    def beat(self, host: int, step: int, step_time_s: float, now: float | None = None):
        now = time.monotonic() if now is None else now
        self._last_beat[host] = (now, step)
        self._step_times.setdefault(host, []).append(step_time_s)
        if len(self._step_times[host]) > 64:
            self._step_times[host] = self._step_times[host][-64:]

    def check(self, step: int, now: float | None = None) -> list[FaultEvent]:
        now = time.monotonic() if now is None else now
        events = []
        for h in range(self.n_hosts):
            beat = self._last_beat.get(h)
            if beat is None or now - beat[0] > self.heartbeat_timeout_s:
                events.append(FaultEvent("dead", h, step, "heartbeat timeout"))
        # straggler: host median step time >> fleet median (robust stats)
        meds = {
            h: float(np.median(t))
            for h, t in self._step_times.items()
            if len(t) >= self.min_history
        }
        if len(meds) >= 2:
            fleet = np.median(list(meds.values()))
            mad = np.median([abs(v - fleet) for v in meds.values()]) + 1e-9
            for h, v in meds.items():
                if v > fleet + self.straggler_mad_k * mad and v > 1.05 * fleet:
                    events.append(
                        FaultEvent("straggler", h, step,
                                   f"median {v:.3f}s vs fleet {fleet:.3f}s")
                    )
        return events


@dataclass
class RestartPolicy:
    max_retries_per_step: int = 2
    _failures: dict = field(default_factory=dict)

    def on_failure(self, step: int) -> str:
        """Returns the action: 'restore' (same mesh) or 'rescale' (smaller)."""
        self._failures[step] = self._failures.get(step, 0) + 1
        if self._failures[step] > self.max_retries_per_step:
            return "rescale"
        return "restore"
