"""Assemble the dry run's tables from its per-cell JSON records.

Counterpart of ``repro/analysis/report.py``: the same tables for the same
records.  The port's records (``launch/dryrun.py``) carry the keys they
read; ``compile_s`` holds the wall seconds of the cell's count on the
host (the port compiles nothing), and every number is counted on fake
tensors, none measured on a device.

    PYTHONPATH=src python -m repro_torch.analysis.report --dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os

GB = 1024**3


def load(dir_: str):
    recs = []
    for fn in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs) -> str:
    out = [
        "| arch | shape | mesh | compile_s | args GiB/dev | temp GiB/dev | "
        "coll GiB/dev (ag/ar/rs/a2a/cp) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("skipped"):
            continue
        c = r["collectives"]
        coll = "/".join(
            f"{c.get(k, 0)/GB:.2f}"
            for k in ("all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute")
        )
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']:.0f} | "
            f"{r['memory']['argument_bytes']/GB:.2f} | "
            f"{r['memory']['temp_bytes']/GB:.2f} | {coll} |"
        )
    return "\n".join(out)


def roofline_table(recs) -> str:
    out = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        rl = r.get("roofline")
        if not rl:
            continue
        out.append(
            f"| {rl['arch']} | {rl['shape']} | {rl['compute_s']:.3e} | "
            f"{rl['memory_s']:.3e} | {rl['collective_s']:.3e} | "
            f"{rl['dominant'].replace('_s','')} | {rl['model_flops']:.3e} | "
            f"{rl['useful_ratio']:.2f} | {rl['roofline_fraction']:.2%} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## §Dry-run (counted on fake tensors, one H100)\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (one H100, data-sheet peaks)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
