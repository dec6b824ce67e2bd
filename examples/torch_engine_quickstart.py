"""Engine quickstart over the PyTorch + CUDA port — serve a stream of SpMV
requests against named matrices.

The one-shot pipeline (repro_torch.api: SparseMatrix -> ExecutionPlan ->
Executor, see examples/torch_spmv_end_to_end.py) re-partitions, re-places
and rebuilds its program on every compile.  The serving engine runs that
chain once at ``register`` and then answers ``multiply`` from a cached
compiled executor; the deadline-aware micro-batcher coalesces concurrent
requests into SpMM calls.

The engine's P parts (``--parts``, default 8) all lie on the one device;
it runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_engine_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api.plan import check_device
from repro_torch.data import paper_small_suite
from repro_torch.engine import SpmvEngine
from repro_torch.engine.batcher import BurstBatcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parts", type=int, default=8,
                    help="the engine's parts, all on the one device")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    rng = np.random.default_rng(0)
    eng = SpmvEngine(devices=[device] * args.parts, cache_capacity=8)
    out = {"plans": {}}

    # ---- register: fingerprint -> adaptive plan -> partition -> place ----
    for spec in paper_small_suite():
        a = spec.build()
        entry = eng.register(spec.name, a)
        p = entry.plan
        out["plans"][spec.name] = (p.partitioning, p.scheme, p.fmt,
                                   tuple(p.grid))
        print(f"registered {spec.name:14s} {p.partitioning}.{p.scheme}.{p.fmt} "
              f"grid={p.grid} "
              f"({'scale-free' if entry.stats.is_scale_free else 'regular'}, "
              f"nnz={entry.stats.nnz})")

    # ---- serve: every multiply hits the cached executor ------------------
    spec = paper_small_suite()[0]
    a = spec.build()
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = eng.multiply(spec.name, x)
    out["multiply_err"] = float(np.abs(y - a @ x).max())
    print(f"\nmultiply({spec.name}): max|err| = {out['multiply_err']:.2e} "
          f"(traces={eng.trace_count(spec.name)}, cache "
          f"hits={eng.cache.stats.hits})")

    # ---- batched stream: concurrent requests coalesce into SpMM ----------
    # the flushes wait until all 32 are queued (BurstBatcher), so they form
    # 4 batches of 8 however fast the host queues them
    with BurstBatcher(eng, burst=32, max_batch=8, buckets=(1, 2, 4, 8)) as mb:
        vecs = [rng.standard_normal(a.shape[1]).astype(np.float32)
                for _ in range(32)]
        futs = [mb.submit(spec.name, v) for v in vecs]
        results = [f.result(timeout=60) for f in futs]
    out["stream_err"] = float(max(np.abs(r - a @ v).max()
                                  for r, v in zip(results, vecs)))
    out["batches"] = mb.batches_run
    print(f"batched stream: 32 requests in {mb.batches_run} SpMM batches, "
          f"max|err| = {out['stream_err']:.2e}")

    # ---- telemetry: the paper's Fig.-17 load/kernel/retrieve split -------
    bd = eng.telemetry.breakdown(spec.name)
    print(f"breakdown({spec.name}): load={bd['load']:.2f} "
          f"kernel={bd['kernel']:.2f} retrieve={bd['retrieve']:.2f} "
          f"over {bd['requests']} requests / {bd['vectors']} vectors")
    out["breakdown"] = bd
    return out


if __name__ == "__main__":
    main()
