"""Serving quickstart over the PyTorch + CUDA port — asyncio multi-tenant
SpMV with admission control.

Two tenants register matrices with an ``AsyncSpmvService`` and a seeded
Zipfian workload (bursty arrivals, mixed vector/batch requests, a slice of
deliberately-infeasible deadlines) is replayed against it.  The SLO report
at the end demonstrates the serving contract:

  * zero lost requests — every request resolves (served or rejected),
  * every accepted request is *bit-equal* to the dense oracle (the
    workload uses integer-valued payloads, for which float32 SpMV is exact
    in any summation order),
  * deadline-infeasible requests are rejected up front — never served late.

The engine's P parts (``--parts``, default 8) all lie on the one device;
it runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_serve_quickstart.py [--device cpu]
"""
import argparse
import asyncio

import numpy as np

from repro_torch.api.plan import check_device
from repro_torch.data.matrices import block_matrix, regular_matrix, scale_free_matrix
from repro_torch.engine import SpmvEngine
from repro_torch.serve import (
    AsyncSpmvService,
    TenantConfig,
    WorkloadSpec,
    describe_trace,
    generate_trace,
    replay,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parts", type=int, default=8,
                    help="the engine's parts, all on the one device")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    # integer-valued matrices: float32 SpMV over them is exact, so the
    # replay can assert bit-equality against the dense oracle rather than
    # allclose
    mats = {
        "social": np.round(scale_free_matrix(96, 128, 700, seed=0) * 2.0),
        "mesh": np.round(regular_matrix(96, 128, 5, seed=1) * 2.0),
        "fem": np.round(
            block_matrix(96, 128, block=(8, 16), block_density=0.2, seed=2)
            * 2.0),
    }

    engine = SpmvEngine(devices=[device] * args.parts, cache_capacity=8)
    service = AsyncSpmvService(
        engine,
        tenants={
            "acme": TenantConfig(max_pending=64),
            "globex": TenantConfig(max_pending=64, rate_rps=5000, burst=128),
        },
    )

    # ---- register: each tenant names its matrices; identical content
    # (acme's and globex's "social"/"mesh"/"fem" here) shares ONE compiled
    # plan in the cache — tenancy isolates admission, not memory ----------
    for tenant in ("acme", "globex"):
        for name, a in mats.items():
            service.register(tenant, name, a)
    plans = {}
    for entry_name in ("acme:social", "globex:fem"):
        p = engine.registry.get(entry_name).plan
        plans[entry_name] = (p.partitioning, p.scheme, p.fmt, tuple(p.grid))
        print(f"registered {entry_name:14s} -> {p.partitioning}.{p.scheme}."
              f"{p.fmt} grid={tuple(p.grid)}")

    # ---- a seeded Zipfian workload over both tenants ---------------------
    spec = WorkloadSpec(
        names=("social", "mesh", "fem"),  # rank order: "social" is the hot head
        tenants=("acme", "globex"),
        n_requests=120,
        seed=42,
        zipf_alpha=1.2,
        rate_rps=2000.0,
        arrivals="bursty",
        batch_mix={1: 0.8, 4: 0.15, 8: 0.05},
        deadline_s=30.0,  # generous SLO for the feasible requests
        infeasible_frac=0.1,  # ...and a slice that MUST be shed
        integer_values=True,
    )
    trace = generate_trace(spec)
    print(f"\nworkload: {describe_trace(trace)}")

    async def run():
        async with service:
            return await replay(service, trace, oracles=mats, time_scale=0.0,
                                integer_values=True)

    report = asyncio.run(run())
    print(f"\n{report.describe()}\n")

    # ---- the serving contract, asserted ----------------------------------
    assert report.lost == 0, "a request was neither served nor rejected"
    assert report.errors == 0, "a backend error leaked into the replay"
    assert report.bitexact == report.verified == report.completed, \
        "an accepted request was not bit-equal to the dense oracle"
    assert report.infeasible_served == 0 and report.late == 0, \
        "a deadline-infeasible request was served (late) instead of shed"
    assert report.infeasible_rejected == sum(r.infeasible for r in trace)
    print("OK: zero lost, all accepted requests bit-equal to the dense "
          f"oracle, {report.infeasible_rejected} infeasible requests shed "
          "up front")
    return {"plans": plans,
            "completed": report.completed, "bitexact": report.bitexact,
            "infeasible_rejected": report.infeasible_rejected,
            "lost": report.lost, "latency_ms": report.latency}


if __name__ == "__main__":
    main()
