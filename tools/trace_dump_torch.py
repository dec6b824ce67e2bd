#!/usr/bin/env python
"""Replay a seeded serving workload against the PyTorch + CUDA port and
dump its spans as a Chrome trace — or merge already-dumped per-worker
traces into one cluster timeline.

Replay mode (no ``--trace`` arguments)::

    PYTHONPATH=src python tools/trace_dump_torch.py [--out serve_trace.json]
                                                    [--requests N] [--seed S]
                                                    [--top K] [--device cpu]

Runs a small two-tenant replay against an in-process
:class:`repro_torch.serve.AsyncSpmvService` on the card (or, with
``--device cpu``, on the host), then:

  * writes the tracer's span buffer as Chrome ``chrome://tracing`` JSON —
    load the file at https://ui.perfetto.dev, each request is one timeline
    row decomposed into admit / queue_wait / batch_form / load / kernel /
    retrieve / deliver spans, and
  * prints the ``--top`` slowest requests' phase breakdowns to stdout, so
    one artifact shows the full life of the worst request without leaving
    the terminal.

Merge mode (one or more ``--trace`` arguments)::

    PYTHONPATH=src python tools/trace_dump_torch.py \\
        --trace w0.json --trace w1.json --out cluster_trace.json

Each input file (one Chrome trace document per worker) becomes one
Perfetto *process* row — ``pid`` = input index, ``process_name`` = the
file's ``--label`` (or its basename) — so an N-worker replay renders as
one cluster timeline.  The merge math lives in
:func:`repro_torch.obs.tracing.merge_chrome_traces`; this script is only
the harness around it.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def build_service(device):
    from repro_torch.data.matrices import regular_matrix, scale_free_matrix
    from repro_torch.engine import SpmvEngine
    from repro_torch.serve import AsyncSpmvService, TenantConfig

    service = AsyncSpmvService(
        SpmvEngine(devices=[device], cache_capacity=8),
        tenants={"tenant-a": TenantConfig(max_pending=128),
                 "tenant-b": TenantConfig(max_pending=128)},
    )
    service.register(None, "social", scale_free_matrix(96, 128, 700, seed=0))
    service.register(None, "mesh", regular_matrix(96, 128, 5, seed=1))
    return service


def merge_traces(paths, labels, out_path: str) -> int:
    """Merge per-worker Chrome trace files into one cluster timeline."""
    from repro_torch.obs.tracing import merge_chrome_traces

    docs = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            docs.append(json.load(fh))
    if labels and len(labels) != len(paths):
        print(f"error: {len(labels)} --label for {len(paths)} --trace",
              file=sys.stderr)
        return 2
    if not labels:
        labels = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    merged = merge_chrome_traces(docs, labels=labels)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(merged, fh)
    n_events = len(merged["traceEvents"])
    print(f"wrote {out_path}: {n_events} events merged from "
          f"{len(paths)} trace(s) ({', '.join(labels)})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", metavar="PATH", default="serve_trace.json",
                    help="Chrome/Perfetto trace JSON output path")
    ap.add_argument("--trace", metavar="PATH", action="append", default=[],
                    help="merge mode: an existing per-worker trace JSON "
                         "(repeatable); skips the replay entirely")
    ap.add_argument("--label", metavar="NAME", action="append", default=[],
                    help="merge mode: process name for the matching "
                         "--trace (repeatable; default: file basename)")
    ap.add_argument("--requests", type=int, default=48,
                    help="replayed trace length")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--top", type=int, default=3,
                    help="print the K slowest requests' phase breakdowns")
    ap.add_argument("--device", default="cuda",
                    help="replay mode: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.trace:
        return merge_traces(args.trace, args.label, args.out)

    from repro_torch.api.plan import check_device
    from repro_torch.obs.tracing import chrome_trace, trace_summary
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    service = build_service(check_device(args.device))
    spec = WorkloadSpec(
        names=("social", "mesh"),
        tenants=("tenant-a", "tenant-b"),
        n_requests=args.requests,
        seed=args.seed,
        zipf_alpha=1.2,
        rate_rps=2000.0,
        arrivals="bursty",
        batch_mix={1: 0.85, 4: 0.1, 8: 0.05},
    )

    async def run():
        async with service:
            # warmup pays each batch width's first touch so the dumped
            # trace shows serving, not the first call of each bucket
            await replay(service, generate_trace(WorkloadSpec(
                names=spec.names, tenants=spec.tenants,
                n_requests=max(16, args.requests // 4), seed=args.seed + 1,
                batch_mix=spec.batch_mix,
            )), time_scale=0.0)
            service.tracer.clear()
            report = await replay(service, generate_trace(spec),
                                  time_scale=0.0)
            return report, service.tracer.spans()

    report, spans = asyncio.run(run())

    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(spans), fh)
    print(f"wrote {args.out}: {len(spans)} spans from "
          f"{report.completed} completed requests "
          f"(span coverage {report.span_coverage:.3f})")

    summaries = trace_summary(spans)
    worst = sorted(summaries.values(), key=lambda t: t["total_s"],
                   reverse=True)[: args.top]
    for rank, t in enumerate(worst, 1):
        phases = " ".join(
            f"{name}={dur * 1e3:.3f}ms"
            for name, dur in sorted(t["phases"].items(),
                                    key=lambda kv: -kv[1])
        )
        print(f"#{rank} {t['label']}: {t['total_s'] * 1e3:.3f}ms e2e, "
              f"coverage {t['coverage']:.3f}")
        print(f"    {phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
