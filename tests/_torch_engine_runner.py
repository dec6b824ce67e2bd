"""Subprocess body of tests/test_torch_engine.py: the JAX engine's side on
P = 4 fake devices (XLA_FLAGS is set before jax imports).

For every case of tests/_torch_engine_cases.py it registers the matrix in
one ``SpmvEngine`` with the partitioning forced, and stores in the .npz
file named on the command line the plan key, the fitted plan and the
answers to x, X and x_rand; then it flushes the batcher case through a
``MicroBatcher`` and stores each future's answer.  Prints ``DEVICES <n>``
first and ``ENGINE SKIP`` when forcing devices failed.

It also runs the engine's solver sessions of SESSIONS (each
``solver_inputs`` case of tests/_torch_mesh_cases.py registered with the
partitioning forced) and stores each session's x, steps and convergence.

With ``--tune`` it runs the tuning cases instead (tests/test_torch_tune.py):
the candidate lists of TUNE_CASES, the Measurements of TUNE_MEASURE under
a quadratic clock, and the FakeMeasurer winner of each matrix, as JSON.
With ``--world`` it runs both into one file
(tests/test_torch_engine_world.py).

    python tests/_torch_engine_runner.py OUT.npz [--tune | --world]
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import SparseMatrix  # noqa: E402
from repro.engine import MicroBatcher, SpmvEngine  # noqa: E402
from repro.tune import CandidateGenerator, FakeMeasurer, Measurer, Tuner  # noqa: E402

from _torch_engine_cases import (BATCHER, CASES, PARTS, SESSIONS,  # noqa: E402
                                 TUNE_CASES, TUNE_MEASURE, TUNE_SEED, case_id,
                                 case_key, matrices, quadratic_clock, vectors)
from _torch_mesh_cases import solver_inputs  # noqa: E402


def tune_cases(devices) -> dict:
    """The tuner's side on P parts, each result as a JSON string."""
    mats, vecs = matrices(), vectors()
    res = {}
    for case in TUNE_CASES:
        matrix, exotic, cap = case
        gen = CandidateGenerator(impls=("xla", "pallas"), include_exotic=exotic,
                                 max_candidates=cap)
        plans = gen.plans(SparseMatrix.from_dense(mats[matrix]), devices=devices)
        res[f"cands|{case_key(case)}"] = [[p.scheme_id, p.impl, list(p.grid), p.fmt]
                                          for p in plans]
    for case in TUNE_MEASURE:
        matrix, scheme, batch = case
        plan = SparseMatrix.from_dense(mats[matrix]).plan(scheme=scheme,
                                                          devices=devices)
        x = vecs["x"] if batch is None else vecs["X"][:, :batch]
        m = Measurer(clock=quadratic_clock()).measure(plan, x)
        res[f"measure|{case_key(case)}"] = [m.scheme_id, m.impl, list(m.grid), m.fmt,
                                            m.mean_s, list(m.times_s), m.compile_s,
                                            m.phases]
    for matrix, a in mats.items():
        r = Tuner(measurer=FakeMeasurer(seed=TUNE_SEED)).tune(
            SparseMatrix.from_dense(a), devices=devices)
        res[f"tuner|{matrix}"] = [r.best.scheme_id, list(r.best.grid),
                                  r.baseline.scheme_id, r.speedup,
                                  [m.scheme_id for m in r.measurements]]
    return {k: np.array(json.dumps(v)) for k, v in res.items()}


def sessions(eng) -> dict:
    """The engine's solver sessions of SESSIONS on its P parts."""
    res = {}
    for combine, part in SESSIONS:
        a, x0, kw = solver_inputs(combine)
        name = f"session.{combine}.{part}"
        eng.register(name, a, partitioning=part, impl="xla")
        r = eng.solve(name, x0, **kw)
        res[f"{name}|x"] = np.asarray(r.x)
        res[f"{name}|steps"] = np.array(r.steps)
        res[f"{name}|converged"] = np.array(r.converged)
    return res


def main(out_path: str, tune: bool = False, world: bool = False) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < PARTS:
        print("ENGINE SKIP")
        return
    if tune:
        np.savez(out_path, **tune_cases(jax.devices()[:PARTS]))
        print("ENGINE DONE")
        return
    mats, vecs = matrices(), vectors()
    eng = SpmvEngine(devices=jax.devices()[:PARTS], cache_capacity=16)
    res = {}
    for matrix, part, impl in CASES:
        cid = case_id(matrix, part, impl)
        entry = eng.register(cid, mats[matrix], partitioning=part, impl=impl)
        p = entry.plan
        res[f"{cid}|key"] = np.array(json.dumps(entry.cache_key))
        res[f"{cid}|plan"] = np.array(json.dumps(
            [p.partitioning, p.scheme, p.fmt, p.merge, list(p.grid), p.reason]))
        for name in ("x", "X", "x_rand"):
            res[f"{cid}|{name}"] = np.asarray(eng.multiply(cid, vecs[name]))
    matrix, part, n = BATCHER
    mb = MicroBatcher(eng, max_batch=4, buckets=(1, 2, 4), auto_flush=False)
    futs = [mb.submit(case_id(matrix, part, "xla"), v) for v in vecs["batcher"]]
    mb.flush()
    res["batcher|y"] = np.stack([f.result(timeout=60) for f in futs])
    res.update(sessions(eng))
    if world:
        res.update(tune_cases(jax.devices()[:PARTS]))
    np.savez(out_path, **res)
    print("ENGINE DONE")


if __name__ == "__main__":
    main(sys.argv[1], tune="--tune" in sys.argv[2:],
         world="--world" in sys.argv[2:])
