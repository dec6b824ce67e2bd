"""SLO-classes quickstart over the PyTorch + CUDA port — rt traffic
preempting bulk under one burst.

Two tenants share one service: ``dashboard`` is ``rt`` class, ``nightly``
is ``batch`` class (``TenantConfig(priority=...)``; see docs/slo.md).  A
seeded bursty workload fires both at once — everything arrives in a rush,
a deep micro-batch queue forms, and batch-formation *order* decides who
waits.  The per-class scorecard at the end demonstrates the SLO-class
contract:

  * the rt tail beats the batch tail — preemption sorts rt requests into
    the first chunks of each flush while bulk work slides back,
  * claims were actually reordered (the ``preemptions`` stat moved),
  * zero lost requests in *either* class — priority reorders work, it
    never drops it,
  * the report scores fairness within each class, so rt out-completing
    batch is not flagged as unfairness.

The burst is held at the batcher until all of it is queued
(``repro_torch.engine.batcher.BurstBatcher``): with the plain batcher the deep queue formed only
when the event loop enqueued the burst faster than the flush threads
drained it, which a loaded host does not promise (the flush threads then
popped a few requests at a time, in arrival order, and the rt tail lost
its lead).

The engine's 8 parts (the JAX script's 8 fake devices) all lie on the one
device; it runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_slo_quickstart.py [--device cpu]
"""
import argparse
import asyncio

import numpy as np

from repro_torch.api.plan import check_device
from repro_torch.data.matrices import regular_matrix
from repro_torch.engine import SpmvEngine
from repro_torch.engine.batcher import BurstBatcher
from repro_torch.serve import (
    AsyncSpmvService,
    WorkloadSpec,
    describe_trace,
    generate_trace,
    replay,
    tenant_configs,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    # one rt tenant vs three bulk streams of the same matrix: the bulk burst
    # is what the dashboard's latency must be protected from
    spec = WorkloadSpec(
        names=("mesh",),
        tenants=("dashboard", "nightly-a", "nightly-b", "nightly-c"),
        n_requests=160,
        seed=7,
        rate_rps=5000.0,
        arrivals="bursty",
        batch_mix={1: 1.0},  # single vectors: everything rides the batcher queue
        integer_values=True,
        tenant_classes={
            "dashboard": "rt",
            "nightly-a": "batch", "nightly-b": "batch", "nightly-c": "batch",
        },
    )
    trace = generate_trace(spec)
    print(f"workload: {describe_trace(trace)}")

    # tenant_configs() lifts the spec's tenant_classes into TenantConfigs;
    # max_batch=4 keeps chunks small so preemption acts chunk by chunk
    engine = SpmvEngine(devices=[device] * 8, cache_capacity=4)
    service = AsyncSpmvService(
        engine,
        batcher=BurstBatcher(engine, burst=len(trace), max_batch=4,
                             buckets=(1, 4), auto_flush=False),
        tenants=tenant_configs(spec, max_pending=640),
    )
    mesh = np.round(regular_matrix(1024, 512, 12, seed=1) * 2.0)
    service.register(None, "mesh", mesh)  # global: all tenants share one plan

    async def run():
        async with service:
            # one throwaway replay pays the first-touch warmup so the scored
            # percentiles describe steady-state serving
            await replay(service, trace, time_scale=0.0, integer_values=True)
            return await replay(service, trace, oracles={"mesh": mesh},
                                time_scale=0.0, integer_values=True)

    report = asyncio.run(run())
    print(f"\n{report.describe()}\n")
    stats = service.stats()

    # ---- the SLO-class contract, asserted --------------------------------
    rt, batch = report.per_class["rt"], report.per_class["batch"]
    assert report.lost == 0, "a request was neither served nor rejected"
    assert report.errors == 0, "a backend error leaked into the replay"
    assert rt["completed"] + batch["completed"] == report.completed
    assert report.bitexact == report.verified == report.completed, \
        "an accepted request was not bit-equal to the dense oracle"
    assert rt["p99_ms"] < batch["p99_ms"], (
        f"rt p99 {rt['p99_ms']:.2f} ms did not beat batch p99 "
        f"{batch['p99_ms']:.2f} ms"
    )
    assert stats["preemptions"] > 0, "no claim was ever reordered by class"
    assert set(report.fairness_by_class) == {"rt", "batch"}
    print(f"OK: rt p99 {rt['p99_ms']:.2f} ms < batch p99 "
          f"{batch['p99_ms']:.2f} ms across {stats['preemptions']} preempted "
          "claims; zero lost in either class")
    return {"completed": report.completed, "bitexact": report.bitexact,
            "rt_p99_ms": rt["p99_ms"], "batch_p99_ms": batch["p99_ms"],
            "preemptions": stats["preemptions"]}


if __name__ == "__main__":
    main()
