"""Dry run of the paper's own workload: distributed SpMV on 256 / 512 parts.

Counterpart of ``repro/launch/dryrun_spmv.py``.  The reference lowers and
compiles the 1D (broadcast-x) and 1D-ring SpMV programs for a paper-scale
synthetic scale-free matrix on its 256- and 512-chip meshes and prints
XLA's memory, cost and collective numbers.  The port counts the same
programs on fake tensors (:mod:`repro_torch.analysis.count`) with the
matrix's P parts on one card, as ``Mesh`` lays them out: the 1D program
with ``impl="cuda"`` (the COO kernel's part axis, which reports its work)
and the ring (its torch loop).  Collective bytes are 0: on one card no
collective runs.

Beside each, the reference's own layout, one part per chip: rank 0 of a
process mesh of P ranks (:func:`count_rank`) on a dry-run mesh
(``core.mesh.dry_process_mesh``), whose collectives count their bytes by
kind as ``core/collectives.py`` counts them on a real world, and move
nothing.  Those records carry the counts under ``collectives`` and price
them at the link rate (``analysis.roofline.LINK_BW``).

The reference lowers its ring on made-up equal bucket counts over a
matrix it never bucketed; running that would give wrong answers.  The
port buckets first: :func:`count_1d` takes the real per-source-shard
counts (``bucket_by_source_shard``'s) and counts the ring over fake
arrays of that layout, which it never fills.  At 2^20 rows on 256 parts
the Zipf columns put about 88 % of a part's nonzeros in shard 0, so the
equal-capacity buckets would hold about 45 GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_spmv \
        [--rows 1048576] [--nnz-per-row 16] [--parts 256 512]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.analysis.count import (Count, counting, fake_mode, fake_tree,
                                        tree_bytes)
from repro_torch.analysis.roofline import LINK_BW, CostTerms
from repro_torch.api import plan_from_partitioned
from repro_torch.core import distributed as D
from repro_torch.core.mesh import dry_process_mesh, make_mesh
from repro_torch.core.partition import PartitionedMatrix

__all__ = ["synth_partition_1d", "ring_layout", "count_1d", "count_rank",
           "main"]


def synth_partition_1d(rows, cols, nnz_per_row, parts, seed=0, device="cuda"):
    """Build a pre-partitioned scale-free COO directly in partitioned form
    (paper-scale matrices never materialize densely): the reference's
    arrays, draw for draw, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    per_part_rows = rows // parts
    nnz_pp = per_part_rows * nnz_per_row
    # Zipf columns (hub structure), already row-sorted within parts
    ranks = np.arange(1, cols + 1, dtype=np.float64)
    p = ranks ** -1.2
    p /= p.sum()
    colind = rng.choice(cols, size=(parts, nnz_pp), p=p).astype(np.int32)
    rowind = np.repeat(
        np.arange(per_part_rows, dtype=np.int32), nnz_per_row
    )[None].repeat(parts, 0)
    values = rng.standard_normal((parts, nnz_pp)).astype(np.float32)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return PartitionedMatrix(
        rowind=t(rowind),
        colind=t(colind),
        values=t(values, torch.float32),
        nnz=t(np.full((parts,), nnz_pp)),
        row_start=t(np.arange(parts) * per_part_rows),
        col_start=t(np.zeros(parts)),
        row_extent=t(np.full((parts,), per_part_rows)),
        col_extent=t(np.full((parts,), cols)),
        shape=(rows, cols),
        grid=(parts, 1),
        fmt="coo",
        scheme="1d.nnz",
        block=(1, 1),
        h_pad=per_part_rows,
        w_pad=cols,
    )


def ring_layout(mat: PartitionedMatrix, mode) -> tuple:
    """``bucket_by_source_shard(mat, P)``'s layout without its data: the
    bucket counts (P, P) from the real columns, and the re-laid matrix as
    fake tensors of ``mode`` (P, P * cap_b)."""
    P = mat.n_parts
    shard_w = -(-mat.shape[1] // P)
    colind, nnz = mat.colind.cpu().numpy(), mat.nnz.tolist()
    counts = np.stack([np.bincount(colind[p, :n] // shard_w, minlength=P)
                       for p, n in enumerate(nnz)]).astype(np.int32)
    cap = P * max(1, int(counts.max()))
    with mode:
        new = dataclasses.replace(
            mat, rowind=torch.empty((P, cap), dtype=torch.int32),
            colind=torch.empty((P, cap), dtype=torch.int32),
            values=torch.empty((P, cap), dtype=mat.values.dtype),
            scheme=mat.scheme + "+ring")
    return new, counts


def _count_ring(program, arrs, x, mode) -> Count:
    """The ring's count from three small ones.  Every (part, step) of the
    ring runs the same ops on the same shapes (a bucket of ``cap_b``
    nonzeros, a shard of x), so a part's y over s steps costs
    ``start + s * step``: count part 0 over one step and over two, and the
    stacking of P ys, and add them up.  An eager count of all P^2 steps
    would take about 100 us an op over 10^6 to 10^7 ops.  Peak: the P ys
    held for the stack, plus one part's own peak."""
    P = program.mat.n_parts
    with mode:
        shards = program.shards(x)
    one = []
    for steps in (1, 2):
        with mode, counting(arrs, x) as c:
            y = program.part_y(arrs, shards, 0, steps)
        one.append(c)
    step = (one[1].flops - one[0].flops, one[1].bytes - one[0].bytes)
    ys = [fake_tree(y, mode) for _ in range(P)]
    with mode, counting(arrs, x, ys) as stack:
        program.stack_parts(ys)
    ops = one[0].ops + (P - 1) * (one[1].ops - one[0].ops)
    total = Count(argument_bytes=one[0].argument_bytes,
                  seconds=one[0].seconds + one[1].seconds + stack.seconds,
                  ops=1 + stack.ops + P * ops)  # 1: the shards' reshape
    total.flops = stack.flops + P * (one[0].flops + (P - 1) * step[0])
    total.bytes = stack.bytes + P * (one[0].bytes + (P - 1) * step[1])
    y_bytes = tree_bytes(y)
    total.peak_bytes = max(stack.peak_bytes, one[1].peak_bytes + (P - 1) * y_bytes)
    return total


def count_1d(mat: PartitionedMatrix, mesh, ring: bool = False) -> Count:
    """Count one SpMV of the 1D program (or the ring) over ``mat``'s parts
    on fake tensors; returns the
    :class:`~repro_torch.analysis.count.Count`.  ``mesh`` holds P places
    of one device (its type is what the plan records; the count runs on
    fake CPU tensors).  The ring is counted from its steps
    (:func:`_count_ring`)."""
    mode = fake_mode()
    if ring:
        part, counts = ring_layout(mat, mode)
        plan = plan_from_partitioned(part, mesh, ring=True, ring_counts=counts)
        arrs = dict(D._arrays(part))
    else:
        plan = plan_from_partitioned(mat, mesh, impl="cuda")
        part = mat
        arrs = dict(D._arrays(mat), **plan._kernel_extra(mat))
    program = plan.program(part)
    arrs = fake_tree(arrs, mode)
    x = fake_tree(torch.empty(plan._x_pad(part), dtype=torch.float32), mode)
    if ring:
        return _count_ring(program, arrs, x, mode)
    with mode, counting(arrs, x) as count:
        program(arrs, x)
    return count


def count_rank(mat: PartitionedMatrix, ring: bool = False,
               rank: int = 0) -> tuple:
    """Count one SpMV of ``rank`` of a process mesh with one rank per part
    of ``mat`` (the 1D program at ``impl="cuda"``, or the ring) on fake
    tensors: its part's arrays, its shard of x.  Returns the
    :class:`~repro_torch.analysis.count.Count` and its collectives'
    counts (``Collectives.snapshot()``: calls, bytes and, meaningless
    here, seconds by kind)."""
    P = mat.n_parts
    mesh = dry_process_mesh((P,), ("data",), rank)
    mode = fake_mode()
    if ring:
        part, counts = ring_layout(mat, mode)
        plan = plan_from_partitioned(part, mesh, ring=True, ring_counts=counts)
        view = D.part_view(part, rank)
        arrs = dict(D._arrays(view))
    else:
        plan = plan_from_partitioned(mat, mesh, impl="cuda")
        part = mat
        view = D.part_view(part, rank)
        arrs = dict(D._arrays(view), **plan._kernel_extra(view))
    program = plan.program(part)
    arrs = fake_tree(arrs, mode)
    x = fake_tree(torch.empty(plan._x_pad(part) // P, dtype=torch.float32),
                  mode)
    with mode, counting(arrs, x) as count:
        program(arrs, x)
    return count, program.coll.snapshot()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--nnz-per-row", type=int, default=16)
    ap.add_argument("--parts", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--out", default="experiments/dryrun_spmv_torch.json")
    args = ap.parse_args(argv)

    recs = []
    for parts in args.parts:
        # the partition axis is the whole mesh: every part is a PIM core
        mesh = make_mesh((parts,), ("data",), devices=["cpu"] * parts)
        mat = synth_partition_1d(args.rows, args.rows, args.nnz_per_row, parts,
                                 device="cpu")
        for ring in (False, True):
            label = f"spmv.1d{'.ring' if ring else ''}.p{parts}"
            c = count_1d(mat, mesh, ring=ring)
            rec = {
                "name": label,
                "parts": parts,
                "chips": 1,
                "counted_on": "fake tensors (FakeTensorMode, CPU)",
                "count_s": c.seconds,
                "argument_bytes": c.argument_bytes,
                "temp_bytes": c.temp_bytes,
                "flops": float(c.flops),
                "bytes": float(c.bytes),
                "kernel_flops": float(c.kernel_flops),
                "collectives": {"total": 0},
            }
            recs.append(rec)
            print(f"[ok] {label}: args={c.argument_bytes/2**30:.2f}GiB "
                  f"temp={c.temp_bytes/2**30:.2f}GiB flops={rec['flops']:.4g} "
                  f"bytes={rec['bytes']:.4g} ({c.seconds:.1f}s)", flush=True)
            # the reference's layout: one part per chip, rank 0's count
            c, coll = count_rank(mat, ring=ring)
            terms = CostTerms.from_counted(c, collectives=coll)
            rec = {
                "name": f"spmv.1d{'.ring' if ring else ''}.rank0of{parts}",
                "parts": parts,
                "chips": parts,
                "counted_on": "fake tensors (FakeTensorMode, CPU), rank 0 "
                              "of a dry-run process mesh",
                "count_s": c.seconds,
                "argument_bytes": c.argument_bytes,
                "temp_bytes": c.temp_bytes,
                "flops": float(c.flops),
                "bytes": float(c.bytes),
                "kernel_flops": float(c.kernel_flops),
                "collectives": dict(coll["bytes"], total=coll["total_bytes"]),
                "collective_s": terms.coll_bytes / LINK_BW,
            }
            recs.append(rec)
            print(f"[ok] {rec['name']}: flops={rec['flops']:.4g} "
                  f"bytes={rec['bytes']:.4g} coll={coll['total_bytes']:,}B "
                  f"({rec['collective_s']:.3e}s at the link rate)", flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
