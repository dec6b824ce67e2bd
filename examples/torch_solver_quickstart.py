"""Solver quickstart over the PyTorch + CUDA port — iterative sessions
with the vector resident on the device.

SpMV's real consumers are iterative solvers: the vector stays resident
between multiplies, so a session should pay ONE plan lookup, one host
round-trip and (when served) one admission — not one per step.  This
script asserts that contract end to end:

  * ``Executor.iterate``: conjugate gradient to tolerance on the SPD 1D
    Laplacian, checked against the dense ``numpy.linalg.solve`` oracle,
    the loop on the device with the residual read every ``check_every``
    steps;
  * ``SpmvEngine.solve``: PageRank by power iteration, one Telemetry
    record for the whole session with per-iteration microseconds;
  * ``AsyncSpmvService.solve``: the same session admitted ONCE, with
    deadline feasibility judged against steps x per-iteration EWMA.

The engine's P parts (``--parts``, default 8) all lie on the one device;
it runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_solver_quickstart.py [--device cpu]
"""
import argparse
import asyncio

import numpy as np

from repro_torch.api import SparseMatrix
from repro_torch.api.plan import check_device
from repro_torch.engine import SpmvEngine
from repro_torch.serve import AsyncSpmvService


async def serve_session(engine, google, n: int) -> dict:
    service = AsyncSpmvService(engine)
    admits = []
    inner = service.admission.admit

    def counting_admit(*args, **kw):
        admits.append(kw)
        return inner(*args, **kw)

    service.admission.admit = counting_admit
    async with service:
        service.register(None, "google2", google)
        result = await service.solve("tenant-a", "google2",
                                     np.full(n, 1.0 / n, np.float32),
                                     steps=32, combine="power")
    assert len(admits) == 1, "a session must charge admission exactly once"
    print(f"served session: {result.steps} steps, one admission, "
          f"residual {result.residual:.2e}")
    return {"steps": result.steps, "residual": float(result.residual),
            "admissions": len(admits)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parts", type=int, default=8,
                    help="the engine's parts, all on the one device")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    # --- 1. api: CG to tolerance against the dense oracle ----------------

    n = 96
    laplacian = (4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32)
    b = np.random.default_rng(0).integers(-2, 3, n).astype(np.float32)

    exe = SparseMatrix.from_dense(laplacian).plan(fmt="csr",
                                                  device=device).compile()
    res = exe.iterate(np.zeros(n, np.float32), tol=1e-5, combine="cg", b=b,
                      max_steps=200, check_every=1)
    x_oracle = np.linalg.solve(laplacian.astype(np.float64),
                               b.astype(np.float64))
    err = float(np.max(np.abs(np.asarray(res.x, np.float64) - x_oracle)))
    print(f"CG on the SPD Laplacian: {res.steps} iterations to "
          f"residual {res.residual:.2e} (converged={res.converged}); "
          f"max |x - oracle| = {err:.2e}")
    assert res.converged and err < 1e-3, "CG must reach the dense solution"
    out = {"cg": {"x": np.asarray(res.x), "steps": res.steps, "err": err,
                  "residual": float(res.residual)}}

    # --- 2. engine: one session, one telemetry record --------------------

    rng = np.random.default_rng(1)
    adj = (rng.random((n, n)) < 0.15).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    google = (0.85 * np.where(adj.sum(0) > 0,
                              adj / np.maximum(adj.sum(0), 1.0), 1.0 / n)
              + 0.15 / n).astype(np.float32)

    engine = SpmvEngine(devices=[device] * args.parts, cache_capacity=4)
    engine.register("google", google)
    pr = engine.solve("google", np.full(n, 1.0 / n, np.float32),
                      tol=1e-6, combine="power", max_steps=200)
    rec = engine.telemetry.last_solve("google")
    print(f"PageRank: {pr.steps} power steps to tol "
          f"({rec.per_iter_s * 1e6:.1f} us/iter on device; "
          f"one RequestRecord covers the whole session)")
    assert pr.converged and rec.steps == pr.steps
    out["pagerank"] = {"x": np.asarray(pr.x), "steps": pr.steps,
                       "per_iter_us": rec.per_iter_s * 1e6}

    # --- 3. serve: one admission per session -----------------------------

    out["served"] = asyncio.run(serve_session(engine, google, n))

    solved = np.asarray(pr.x, np.float64)
    ref = np.full(n, 1.0 / n)
    for _ in range(200):
        y = google.astype(np.float64) @ ref
        ref = y / max(np.linalg.norm(y), 1e-30)
    assert np.allclose(solved / solved.sum(), ref / ref.sum(), atol=1e-5)
    print("solver quickstart OK")
    return out


if __name__ == "__main__":
    main()
