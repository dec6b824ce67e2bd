#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (every check raises, so any failure exits non-zero):

1. The card: ``nvidia-smi`` name and power limit; the CUDA kernels are built
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel)
   and their ``-Xptxas -v`` register report is printed, with the count of
   tensor-core instructions (HMMA) in the block kernel's SASS.
2. Each kernel against its plain PyTorch version on the card, at 65,536^2
   with about 1M nonzeros: values in {f32, bf16, i8, i32} x {SpMV, SpMM B=8,
   B=40 ragged, and B=64 for the block kernel}.  Integer-valued inputs must agree bit for bit; random f32
   at rtol=atol=2e-4 (tests/test_kernels.py's tolerance).  SpMM results must
   be bit-identical across two batch tiles.  The COO kernel also runs a
   matrix whose first window holds 262,144 nonzeros (a full row of 65,536
   and 384 rows of 512), which it splits into pieces.
3. The main path, through ``SparseMatrix.from_parts(...).plan(scheme="auto")
   .compile()``, on three matrices built from ``--seed`` after the recipes of
   ``repro/data/matrices.py`` (integer values in {±1, ±2}; x in {-2..2}, so
   every float32 sum is exact): regular 2,097,152^2 (COO and CSR),
   scale-free 2,097,152^2 (COO), block 1,048,576^2 in (8, 16) blocks (BCOO and
   BCSR).  Each plan answers 16 ``exe(x)`` and 4 ``exe.batch(X)``; every
   answer must equal the kernel's plain version on the card and cuSPARSE
   (``torch.sparse_csr_tensor @ x``, an independent oracle the port never
   calls) bit for bit, and the launch counters must rise by the requests.
4. Times at the main-path shapes (CUDA events, after warm-up) at B = 1, 8
   and 64: the kernel, its plain version, cuSPARSE, and the bound — the
   bytes the product must move (each input once, each output once) over
   3.35 TB/s, or its operations over 67 TFLOP/s (f32, no tensor cores),
   whichever is larger; each block case names the route it took.  Then the
   COO kernel's piece size M swept on the COO plans at B=1, and its two
   passes timed apart by torch.profiler.
5. The ELL kernel against its plain version at 65,536^2 with K = 16 and 48,
   as phase 2.
6. The ELL path at full width, through the ``kernels`` entry point
   ``ell_spmv``: the regular matrix with K=16 and the block matrix read as
   scalar ELL with K=48 (the scale-free matrix is left out: its densest row
   would pad every row to K = 2,097,152).  Answers equal the plain version
   and cuSPARSE bit for bit; kernel, plain and cuSPARSE times and the bound.
7. The partitioned path at full width: each matrix through
   ``SparseMatrix.plan(scheme="auto", devices=["cuda"] * 16).compile()``,
   and on the regular matrix the forced schemes 1d.nnz, 2d.equally-wide and
   2d.variable-sized, 16 ``exe(x)`` and 4 ``exe.batch(X)`` each.  Answers
   equal the single-device kernel and cuSPARSE bit for bit, and the
   launch counters rise by one part-axis launch per request.  Then each
   plan's part-axis launch is held against its per-part plain versions and
   timed next to the single-device kernel.  The 1D ring (torch local kernel
   only) runs at 65,536^2.
8. The serving path at full width (``repro_torch.engine`` /
   ``repro_torch.serve``): the three matrices registered from their
   triplets in one ``SpmvEngine()`` on the card (one part each), wrapped in
   an ``AsyncSpmvService`` with an rt, a standard and a batch tenant.  Per
   matrix 64 concurrent single vectors (coalesced by the batcher into
   SpMMs of the bucket widths 1, 2, 4, 8) and explicit B=4 and B=8 batches,
   every answer bit-equal to cuSPARSE; then a seeded bursty trace of 600
   requests (Zipf 1.1 over the matrices, 300 requests/s, widths 1/4/8,
   5 % expired deadlines) replayed in real time: nothing lost, no error,
   every expired request shed.  Latency p50/p99 and throughput per matrix
   and per class, the load / kernel / retrieve split, the widths served and
   the launches per kernel route.  An engine with ``cache_capacity=1``
   evicts a plan and ``torch.cuda.memory_allocated`` must fall by its
   placed bytes; an engine over 16 parts of the card answers a few
   requests, checked the same way.  The block kernel is timed at the
   batcher's widths B = 2 and 4 (the route it takes, and the tensor-core
   route for comparison, each held bit-equal to its plain version first).
9. A replay at 65,536^2 (the three recipes) with dense oracles on the card
   (``replay(..., oracles=...)``): every completed answer bit-equal.
10. Solver sessions (``exe.iterate``, ``SpmvEngine.solve``,
   ``AsyncSpmvService.solve``), x on the card between steps, with inputs
   from their own generator (seeded from ``--seed``), so phases 1-9 draw
   as before.  (a) Every main-path plan and the three 16-part auto plans of
   phase 7: 3 plain steps bit-equal to 3 host ``exe(x)`` calls, and on the
   regular and block matrices to 3 cuSPARSE products (rows sum |a| <= 32
   and <= 96, so every partial sum stays below 2^24).  (b) Tol mode:
   Jacobi on the regular recipe plus 64 on the diagonal, tol 1e-2, checked
   every 8 steps: converged in a multiple of 8 steps, bit-equal to a numpy
   float32 host loop over ``exe(x)``.  (c) 100-step power sessions on the
   regular COO, scale-free COO and block BCOO plans: per-step us, the cold
   (first) session apart from the warm ones, beside the B=1 kernel ms of
   phase 4 and the host loop's ms per step.  Runs after phase 7.  (d) After
   phase 8, on its engine: per matrix four concurrent 20-step power
   sessions and a burst of 64 single multiplies; multiplies bit-equal to
   cuSPARSE, sessions within 1e-4 of a float64 power loop (cuSPARSE in
   float64), one ``kind="solve"`` record of 20 steps per session, and the
   load / kernel / retrieve split of the multiplies with every thread on
   its own stream.  (e) After phase 9, on its engine and oracles: a replay
   of 120 requests with 30 % six-step power sessions; nothing lost, no
   error, every completed session verified, max |err| <= 1e-4.  Each part
   requires its launches to equal the multiplies plus the sessions' steps.
11. Tuning on the card (``repro_torch.tune``), after phase 10 (d), with
   inputs from its own generator.  (a) ``plan(scheme="tune")`` with a real
   Measurer (warmup 2, iters 5, trim 1) and a cache file: the three
   matrices at B=1, block and regular at B=8, single-device.  One line per
   candidate: ``mean_s`` (exe(x) with both copies, what the tuner ranks),
   ``compile_s`` and the kernel's ms by CUDA events on the program it
   compiled, with its rank by each.  Every planned candidate must be
   measured (a kernel candidate that raises stops the tune; each exception
   is printed),
   the launches must equal the measured calls plus the timing launches,
   and the winner must answer bit-equal to cuSPARSE and to the plain
   version.  (b) The same tunes from the cache file: no miss, no
   measurement, no launch, the same winner.  (c) Scale-free on 16 parts:
   every candidate's load / kernel / retrieve > 0 and its kernel phase no
   shorter than its part-axis launch.  (e) The card memory allocated after
   (a)-(c) equals that before.  (d) ``SpmvEngine(tune=True, tune_after=8)``
   over the three matrices, a client thread multiplying all through: 8
   width-1 multiplies per matrix give one ``traffic`` refinement each,
   then width 8 a ``drift`` one; every event measured all the candidates
   it planned, every answer bit-equal to cuSPARSE, and
   launches = multiplies + 4 per measured candidate (warmup 1, iters 3) +
   1 per swap (the winner's warm-up).  (f) The tuner over
   ``paper_large_suite()`` of ``repro_torch.data.matrices`` (22 matrices at
   2048^2), every winner within 2e-4 of the dense product; a correctness
   sweep whose times are host overhead.
12. The multi-process cluster (``repro_torch.cluster``) at full width, last,
   after phase 9, with inputs from its own generator: the three recipes
   again (scipy CSR in float32 as the host oracles), a ``ClusterRouter``
   of two engine workers, each its own process with its own CUDA context
   and ``SpmvEngine`` on the one card.  (a) Each matrix registered from
   int32-index triplets on one worker: frame bytes (under the protocol's
   1 GiB cap), the router's wall s, the worker's register s and the card
   memory it took.  (b) Per matrix 8 B=1, 2 B=4 and 2 B=8 multiplies
   through the router, bit-equal to the oracle, their router-clock p50
   beside phase 3's ``exe(x)`` p50 and phase 4's kernel ms; on every
   worker the kernel launches equal the multiplies it served.  (c) The
   block matrix tuned here at B=1 (real Measurer, cache file) and shipped
   as a tune record (0 measurements on the worker, a cache hit, the
   winner's scheme id), and the regular matrix's ``1d.nnz`` CSR plan
   shipped as IR (its scheme id kept); answers bit-equal.  (d) One 20-step
   power session per matrix through ``router.solve`` within 1e-4 of a
   float64 host loop, its steps charged to its placement and launched by
   its worker.  (e) Generator mode: two spawned load processes (no CUDA)
   replay 120 requests (Zipf 1.1 over the three, widths 1/4/8 at
   0.6/0.25/0.15) straight at the workers: 0 mismatched, 0 lost.  (f)
   Router mode on 4 threads over another 120 requests, worker w0 killed
   (SIGKILL) after 40 answers: 0 lost, 0 mismatched, every shed
   ``worker_lost``, w0's own matrices re-homed on w1, which then answers
   every matrix bit-exactly, and within 10 s of the kill the card's free
   bytes (``mem_get_info``, sampled every 20 ms) rise by at least half of
   what w0 took.  The workers' launch counters start at 0 with them; their
   sum before the kill is the cluster path's count.
13. Topology-aware placement (``repro_torch.topo``) at full width, right
   after phase 10 (a)-(c), on phase 3's matrices, with inputs from its own
   generator (``[seed, 13]``); integer-valued x throughout.  (a) The
   detector: ``detect_topology()`` and ``detect_topology(["cuda"] * 16)``
   (one flat axis); 16 parts of the regular matrix under the second, by
   ``scheme="auto"`` and ``"2d"``, bit-equal to phase 7's flat plan.  (b)
   ``FakeTopology.pim_like((2, 2))`` over ``["cuda"] * 4`` and
   ``pim_like((4, 4))`` over ``["cuda"] * 16``: each matrix through
   ``plan(scheme="2d", topology=)`` and ``plan(topology=)``: the grid
   beside the flat near-square one, the assignment, the transfer the
   model prices (modelled on the preset's declared links, not a time),
   partition s, part-axis kernel ms, bound, cuSPARSE ms and ``exe(x)``
   p50; answers at B=1 and B=8 bit-equal to the single-device kernel and
   cuSPARSE, one part-axis launch per request.  (c) Every assignment of
   ``pim2x2`` on the (2, 2) grid of the block and regular matrices: y
   identical across assignments, ``Mesh.slots`` the ``device_order`` of
   arange(4), kernel ms side by side (the model's assignment is (b)'s
   ``"2d"`` executor, not built twice).  (d) The worst placement's plan IR
   read back with and without the topology: the same ``@`` scheme id and
   answers; the recorded slots with it, flat slots without (as the JAX
   package lays it out).  (e) ``SpmvEngine(devices=["cuda"] * 4,
   topology=pim2x2, tune=True)`` on the block matrix, refined at B=1 over
   four candidates: one per assignment of each of the first two schemes'
   grids, the key's pool ``cuda:4|pim2x2:2x2``, the winner bit-equal,
   launches = warm-up +
   multiplies + 4 per measured candidate + the swap's warm-up; a second
   tune hits the cache: 0 measurements, 0 launches, card memory unchanged
   to the byte.  Its launches are ``launches_by_path[...]["topology"]``.

Each path's launch counters are set to 0 just before it runs and read just
after; the partitioned path does so around each plan's requests and sums
the counts, so that the single-device answers it compares with are
launched outside the count; the solver sessions do so around each session.
The serving path does so around each
service's traffic and requires the COO and block launches to equal the
engine's multiplies: the batcher's coalesced batches plus the explicit
batches served (one part-axis launch each).  Prints JSON lines; the line before the last
is ``{"kernels": [...]}`` and the last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
F32_OPS_S = 67e12  # H100 SXM data sheet, float32 without tensor cores
PM12 = np.array([-2, -1, 1, 2], np.float32)

KERNELS = {  # kernel -> (source, TPU kernel it replaces)
    "coo_spmv": ("src/repro_torch/kernels/csrc/coo_spmv.cu",
                 "src/repro/kernels/coo_spmv.py:165"),
    "bcoo_spmv": ("src/repro_torch/kernels/csrc/bcoo_spmv.cu",
                  "src/repro/kernels/bcsr_spmv.py:76"),
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:66"),
}
# the same CUDA kernel also replaces these TPU kernels
ALSO_REPLACES = {"coo_spmv": ["src/repro/kernels/csr_spmv.py:52"]}
KIND = {"coo_spmv": "coo", "bcoo_spmv": "bcoo", "ell_spmv": "ell"}
PARTS = 16  # parts of the partitioned path, all on the one card
# the serving path's tenants, one per SLO class
TENANTS = {"tenant-rt": "rt", "tenant-std": "standard", "tenant-batch": "batch"}
SERVE_WAIT_S = 600  # bound on any one await of the serving phases


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------- matrices


def regular_triplets(rng, n: int, k: int = 16):
    """Banded-jitter rows (data/matrices.py:regular_matrix) with k distinct
    columns per row: one jittered offset in each of k strata of the band,
    wrapped around the matrix edge."""
    band = n // 16
    width = 2 * band // k
    offs = -band + np.arange(k) * width + rng.integers(0, width, (n, k))
    cols = (np.arange(n)[:, None] + offs) % n
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return rows, cols.reshape(-1), rng.choice(PM12, n * k), (n, n)


def scale_free_triplets(rng, n: int, nnz_target: int, alpha: float = 1.6):
    """Zipf row degrees toward ``nnz_target`` capped at n, and Zipf hub
    columns (data/matrices.py:scale_free_matrix).  Rows above 64 nonzeros
    take distinct uniform columns; the rest draw from the hub distribution,
    duplicates in a row merged."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    deg = ranks ** (-alpha)
    deg = np.maximum(1, np.round(deg / deg.sum() * nnz_target)).astype(np.int64)
    deg = np.minimum(deg, n)
    rng.shuffle(deg)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    col_ids = rng.permutation(n)
    light = deg <= 64
    rows = np.repeat(np.flatnonzero(light), deg[light])
    cols = col_ids[np.minimum(np.searchsorted(cdf, rng.random(len(rows))), n - 1)]
    keys = [np.unique(rows * n + cols)]
    for r in np.flatnonzero(~light):
        keys.append(r * n + np.sort(rng.choice(n, deg[r], replace=False)))
    keys = np.sort(np.concatenate(keys))
    return keys // n, keys % n, rng.choice(PM12, len(keys)), (n, n)


def block_triplets(rng, n: int, block=(8, 16), per: int = 3):
    """Dense (r, c) blocks, ``per`` in every block-row, at distinct, jittered,
    banded block-columns (data/matrices.py:block_matrix, banded)."""
    r, c = block
    nbr, nbc = n // r, n // c
    band = nbc // 16
    width = 2 * band // per
    offs = -band + np.arange(per) * width + rng.integers(0, width, (nbr, per))
    bc = (np.arange(nbr)[:, None] * nbc // nbr + offs) % nbc  # (nbr, per)
    shape4 = (nbr, per, r, c)
    rows = np.broadcast_to(np.arange(nbr)[:, None, None, None] * r
                           + np.arange(r)[None, None, :, None], shape4)
    cols = np.broadcast_to(bc[:, :, None, None] * c + np.arange(c), shape4)
    nnz = nbr * per * r * c
    return rows.reshape(-1), cols.reshape(-1), rng.choice(PM12, nnz), (n, n)


def random_triplets(rng, n: int, per_row: int, integer: bool):
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rng.integers(0, n, n * per_row)
    vals = (rng.choice(PM12, n * per_row) if integer
            else rng.standard_normal(n * per_row).astype(np.float32))
    return rows, cols, vals, (n, n)


def heavy_window_triplets(rng, n: int, integer: bool):
    """``random_triplets`` with 16 per row, but the first 512-row window
    holds 262,144 nonzeros: row 0 full (n columns) and rows 1..384 with 512
    distinct columns each (rows 385..511 empty).  The CUDA kernel splits
    that window into pieces.  Random values of a heavy row are scaled by
    1/sqrt(its length), so that its sum has unit spread and the 2e-4
    tolerance holds the kernel, not float32's rounding of a 65,536-term
    sum, to account."""
    rows, cols, vals, shape = random_triplets(rng, n, 16, integer)
    keep = rows >= 512
    heavy_rows = np.concatenate([np.zeros(n, np.int64), np.repeat(np.arange(1, 385), 512)])
    heavy_cols = np.concatenate([np.arange(n)] + [np.sort(rng.choice(n, 512, replace=False))
                                                  for _ in range(384)])
    heavy_vals = (rng.choice(PM12, len(heavy_rows)) if integer
                  else (rng.standard_normal(len(heavy_rows)) / np.sqrt(
                      np.where(heavy_rows == 0, n, 512))).astype(np.float32))
    return (np.concatenate([heavy_rows, rows[keep]]),
            np.concatenate([heavy_cols, cols[keep]]),
            np.concatenate([heavy_vals, vals[keep]]), shape)


def random_block_triplets(rng, n: int, integer: bool, block=(8, 16)):
    """One dense (r, c) block per block-row at a random block-column."""
    r, c = block
    nbr = n // r
    bc = rng.integers(0, n // c, nbr)
    shape4 = (nbr, r, c)
    rows = np.broadcast_to(np.arange(nbr)[:, None, None] * r
                           + np.arange(r)[None, :, None], shape4)
    cols = np.broadcast_to(bc[:, None, None] * c + np.arange(c), shape4)
    size = nbr * r * c
    vals = (rng.choice(PM12, size) if integer
            else rng.standard_normal(size).astype(np.float32))
    return rows.reshape(-1), cols.reshape(-1), vals, (n, n)


# ------------------------------------------------------------- helpers


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def ptxas_summary(log: str) -> list:
    """(kernel with template arguments, "Used ..." line, spill line) for each
    kernel that an ``nvcc -Xptxas -v`` log compiles."""
    names = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
             "a": "i8", "s": "i16", "i": "i32"}
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?\d+([a-z_]+_kernel)I(\w+?)((?:Li\d+E)*)EEv", line)
        if m:
            ints = re.findall(r"Li(\d+)E", m.group(3))
            entry = " ".join([m.group(1), names.get(m.group(2), m.group(2))] + ints)
        elif "spill" in line and entry:
            spill = line.strip()
        elif "Used" in line and entry:
            out.append((entry, line.split(":", 1)[1].strip(), spill))
            entry = None
    return out


def ptxas_lines(build) -> list:
    """One line per compiled kernel: template arguments, registers, spills."""
    return [f"ptxas {name}[{entry}]: {used}; {spill}"
            for name in build.SOURCES
            for entry, used, spill in ptxas_summary(build.build_log(name))]


def sass_mma_counts(build, name: str) -> dict:
    """Tensor-core instructions (HMMA) per kernel in the SASS of a built
    library, from cuobjdump; {"cuobjdump": "not run: ..."} without it."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not run: not found"}
    res = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                         capture_output=True, text=True, timeout=120)
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : \S*?\d+([a-z_]+_kernel)I(\w+?)((?:Li\d+E)*)EEv",
                      line)
        if m:
            args = [m.group(2)] + re.findall(r"Li(\d+)E", m.group(3))
            fn = f"{m.group(1)}<{','.join(args)}>"
        elif fn and re.search(r"\bHMMA\b", line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


# ------------------------------------------------------------- phases


def phase_kernels(torch, rng, device, n: int, errs: dict, rng64) -> None:
    """Each kernel vs its plain version at 65,536^2 x ~1M nnz.  The block
    kernel's B=64 inputs come from ``rng64``, so that ``rng`` feeds every
    later phase the same matrices whatever cases this phase adds."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8,
              "i32": torch.int32}
    to_coo = lambda ri, ci, v, s: F.triplets_to_coo(ri, ci, v, s)  # noqa: E731
    makers = {("coo_spmv", "random"): (
                  lambda integer: random_triplets(rng, n, 16, integer), to_coo),
              ("coo_spmv", "heavy-window"): (
                  lambda integer: heavy_window_triplets(rng, n, integer), to_coo),
              ("bcoo_spmv", "random"): (
                  lambda integer: random_block_triplets(rng, n, integer),
                  lambda ri, ci, v, s: F.triplets_to_bcoo(
                      ri, ci, v, s, block=(8, 16)))}
    for (kernel, matrix), (triplets, build) in makers.items():
        cases = [(name, dt, True) for name, dt in dtypes.items()]
        cases.append(("f32-random", torch.float32, False))
        for name, dtype, integer in cases:
            ri, ci, vals, shape = triplets(integer)
            m = build(ri, ci, F.to_tensor(vals, dtype), shape)
            prog = ops.kernel_program(m, device=device)
            nnz, case_err = len(ri), 0.0
            batches = (None, 8, 40) + ((64,) if kernel == "bcoo_spmv" else ())
            for batch in batches:
                xshape = (n,) if batch is None else (n, batch)
                g = rng64 if batch == 64 else rng
                xv = (g.integers(-2, 3, xshape) if integer
                      else g.standard_normal(xshape))
                x = torch.from_numpy(xv).to(device, dtype)
                got, want = prog(x), prog.plain(x)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{kernel} {name} B={batch}: {got.dtype}{tuple(got.shape)} "
                      f"vs plain {want.dtype}{tuple(want.shape)}")
                err = max_err(torch, got, want)
                case_err = max(case_err, err)
                if integer:
                    check(torch.equal(got, want),
                          f"{kernel} {name} B={batch}: max |kernel - plain| = {err}")
                else:
                    check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                          f"{kernel} {name} B={batch}: max |kernel - plain| = {err}")
                if batch is not None:
                    other = dataclasses.replace(prog, batch_tile=8)
                    check(torch.equal(other(x), got),
                          f"{kernel} {name} B={batch}: batch tiles 8 and 32 differ")
            pieces = {}
            if matrix == "heavy-window":
                pieces = {"window0_chunks": int(prog.plan.window_start[1]),
                          "window0_pieces": int((prog.plan.pieces[:, 0] == 0).sum())}
                check(pieces["window0_pieces"] > 1, f"heavy window not split: {pieces}")
            emit({"phase": "kernel_vs_plain", "kernel": kernel, "matrix": matrix,
                  "values": name, "shape": list(shape), "nnz": nnz, **pieces,
                  "max_abs_err": case_err, "ok": True})
            errs[kernel] = max(errs[kernel], case_err)
            del prog, m
    torch.cuda.empty_cache()


def library_csr(torch, sm, device):
    csr = sm.container("csr")
    nnz = csr.nnz
    return torch.sparse_csr_tensor(csr.rowptr.to(device), csr.colind[:nnz].to(device),
                                   csr.values[:nnz].to(device), size=sm.shape)


def phase_main_path(torch, rng, device, sizes, errs, records) -> None:
    """Serve requests through the public pipeline at real size."""
    from repro_torch.api import SparseMatrix
    from repro_torch.kernels import instrument

    n_reg, n_sf, n_blk = sizes
    cells = [
        ("regular", lambda: regular_triplets(rng, n_reg),
         [(None, "2d.equally-sized.coo.psum_scatter"),
          ("csr", "2d.equally-sized.csr.psum_scatter")]),
        ("scale-free", lambda: scale_free_triplets(rng, n_sf, 8 * n_sf),
         [(None, "1d.nnz.coo.ppermute")]),
        ("block", lambda: block_triplets(rng, n_blk),
         [(None, "2d.equally-sized.bcoo.psum_scatter"),
          ("bcsr", "2d.equally-sized.bcsr.psum_scatter")]),
    ]
    instrument.reset()
    requests = {"coo": 0, "coo.spmm": 0, "bcoo": 0, "bcoo.spmm": 0}
    for name, make, plans in cells:
        t0 = time.perf_counter()
        ri, ci, vals, shape = make()
        sm = SparseMatrix.from_parts(ri, ci, vals, shape)
        del ri, ci, vals
        st = sm.stats
        setup_s = time.perf_counter() - t0
        A = library_csr(torch, sm, device)
        emit({"phase": "matrix", "matrix": name, "shape": list(shape),
              "nnz": st.nnz, "nnz_r_std": st.nnz_r_std, "nnz_r_max": st.nnz_r_max,
              "block_fill": st.block_fill, "setup_s": setup_s})
        for fmt, want_id in plans:
            pln = sm.plan(scheme="auto", fmt=fmt, device=device)
            check(pln.scheme_id == want_id,
                  f"{name}: auto gave {pln.scheme_id}, expected {want_id}")
            print(pln.describe(), flush=True)
            t0 = time.perf_counter()
            exe = pln.compile()
            compile_s = time.perf_counter() - t0
            prog = exe.program
            kernel = "coo_spmv" if prog.kind == "coo" else "bcoo_spmv"
            lat = {1: [], 8: [], 64: []}
            for i in range(20):
                batch = None if i < 16 else (8, 64)[i % 2]
                xshape = (shape[1],) if batch is None else (shape[1], batch)
                x = rng.integers(-2, 3, xshape).astype(np.float32)
                t0 = time.perf_counter()
                y = exe(x) if batch is None else exe.batch(x)
                lat[batch or 1].append(time.perf_counter() - t0)
                requests[prog.kind] += 1
                requests[prog.kind + ".spmm"] += batch is not None
                check(y.shape == (shape[0],) + xshape[1:] and np.isfinite(y).all(),
                      f"{name}/{pln.fmt}: bad answer shape {y.shape}")
                xd = torch.from_numpy(x).to(device)
                plain = prog.plain(xd).cpu().numpy()
                lib = (A @ xd).cpu().numpy()
                errs[kernel] = max(errs[kernel], float(np.abs(y - plain).max()))
                check(np.array_equal(y, plain),
                      f"{name}/{pln.fmt} request {i}: kernel != plain version")
                check(np.array_equal(y, lib),
                      f"{name}/{pln.fmt} request {i}: kernel != cuSPARSE")
            emit({"phase": "main_path", "matrix": name, "fmt": pln.fmt,
                  "scheme_id": pln.scheme_id, "requests": 20, "compile_s": compile_s,
                  "host_ms_p50": {b: 1e3 * statistics.median(v)
                                  for b, v in lat.items()},
                  "answers": "bit-equal to plain and cuSPARSE"})
            records.append(dict(matrix=name, fmt=pln.fmt, kernel=kernel, exe=exe,
                                prog=prog, A=A, st=st, shape=shape, sm=sm,
                                host_ms=1e3 * statistics.median(lat[1])))
        del sm
    got = {k: instrument.launches(k) for k in requests}
    emit({"phase": "launch_counts", "launches": got, "requests": requests})
    return got, requests


def kernel_route(prog, batch: int) -> str:
    """The route of the block kernel that a program takes at B (COO: one)."""
    if prog.kind != "bcoo":
        return "coo"
    from repro_torch.kernels.bcsr_spmv import block_route

    return block_route(prog.bvalues.dtype, *prog.bvalues.shape[-2:], batch)


def phase_times(torch, rng, device, records) -> dict:
    """Kernel, plain and cuSPARSE times at the main-path shapes."""
    rows = {}
    for rec in records:
        prog, A, st = rec["prog"], rec["A"], rec["st"]
        rows_, cols = rec["shape"]
        for batch in (1, 8, 64):
            xshape = (cols,) if batch == 1 else (cols, batch)
            x = rng.integers(-2, 3, xshape).astype(np.float32)
            x = torch.from_numpy(x).to(device)
            if prog.kind == "coo":
                nbytes = st.nnz * (8 + 4)
            else:
                r, c = prog.bvalues.shape[1:]
                nbytes = prog.nblocks * (r * c * 4 + 4) + (prog.browptr.numel()) * 4
            nbytes += cols * batch * 4 + rows_ * batch * 4
            ops_ = 2 * st.nnz * batch
            by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
            row = {
                "matrix": rec["matrix"], "fmt": rec["fmt"], "kernel": rec["kernel"],
                "B": batch, "nnz": st.nnz, "route": kernel_route(prog, batch),
                "ms": time_ms(torch, lambda: prog(x), 30),
                "plain_ms": time_ms(torch, lambda: prog.plain(x), 5, warmup=1),
                "library_ms": time_ms(torch, lambda: A @ x, 30),
                "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "bytes": nbytes,
            }
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            if batch == 1:
                row["host_exe_ms_p50"] = rec["host_ms"]
            emit({"phase": "times", **row})
            rows[(rec["matrix"], rec["fmt"], batch)] = row
    return rows


def phase_pieces(torch, rng, device, records) -> list:
    """The piece size M of the COO kernel: the single-device COO plans at
    B=1 with pieces of at most M chunks (answers equal at every M), and at
    the default M the device time of its two passes from torch.profiler."""
    from repro_torch.kernels.coo_spmv import PIECE_CHUNKS, coo_spmv, plan_pieces

    rows_out = []
    for rec in records:
        if rec["fmt"] != "coo":
            continue
        prog = rec["prog"]
        x = torch.from_numpy(rng.integers(-2, 3, rec["shape"][1])
                             .astype(np.float32)).to(device)
        want = prog(x)
        for M in (8, 16, 32, 64, 128):
            pieces, splits = plan_pieces(prog.plan.window_start, M)
            plan = dataclasses.replace(prog.plan, pieces=pieces.to(device),
                                       splits=splits.to(device))
            check(torch.equal(coo_spmv(plan, x), want),
                  f"{rec['matrix']}: pieces of {M} chunks change the answer")
            row = {"matrix": rec["matrix"], "M": M, "default": M == PIECE_CHUNKS,
                   "pieces": int((plan.pieces[:, 0] >= 0).sum()),
                   "slots": int(plan.splits.shape[0]),
                   "ms": time_ms(torch, lambda: coo_spmv(plan, x), 30)}
            emit({"phase": "piece_size", **row})
            rows_out.append(row)
        emit({"phase": "coo_passes", "matrix": rec["matrix"],
              **device_split(torch, lambda: prog(x), ("coo_piece_kernel",
                                                      "coo_merge_kernel"))})
    return rows_out


def device_split(torch, fn, names, iters: int = 20) -> dict:
    """Mean device ms per call of each named kernel, from torch.profiler;
    {"profiler": "not measured", ...} when the trace holds no device time."""
    try:
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            us = getattr(ev, "cuda_time_total", 0.0) if us is None else us
            for name in names:
                if name in ev.key:
                    out[name] += us / 1e3 / iters
        if not any(out.values()):
            return {"profiler": "not measured: no device time in the trace"}
        return {f"{k}_ms": v for k, v in out.items()}
    except Exception as e:  # a measurement only; the checks stand apart
        return {"profiler": f"not measured: {type(e).__name__}: {e}"}


def ell_bound(rows: int, K: int, cols: int, batch: int, vbytes: int = 4,
              abytes: int = 4):
    """(bound ms, bound_by, bytes): the ELL arrays, row_nnz, x and y moved
    once; 2 operations per real slot and column."""
    nbytes = rows * K * (4 + vbytes) + rows * 4 + cols * batch * vbytes \
        + rows * batch * abytes
    ops_ = 2 * rows * K * batch
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes


def phase_ell_kernel(torch, rng, device, n: int, errs: dict) -> None:
    """The ELL kernel vs its plain version at 65,536^2 with K = 16 and 48."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.ell_spmv import _pack_ell, ell_spmv, ell_spmv_plain

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8,
              "i32": torch.int32}
    cases = [(name, dt, True, per) for per in (16, 48)
             for name, dt in dtypes.items()]
    cases += [("f32-random", torch.float32, False, per) for per in (16, 48)]
    for name, dtype, integer, per in cases:
        ri, ci, vals, shape = random_triplets(rng, n, per, integer)
        ri, ci, v = F.coalesce(ri, ci, F.to_tensor(vals, dtype), shape)
        arrs = [t.to(device) for t in _pack_ell(ri, ci, v, n, per)]
        case_err = 0.0
        for batch in (None, 8, 40):
            xshape = (n,) if batch is None else (n, batch)
            xv = (rng.integers(-2, 3, xshape) if integer
                  else rng.standard_normal(xshape))
            x = torch.from_numpy(xv).to(device, dtype)
            got, want = ell_spmv(*arrs, x), ell_spmv_plain(*arrs, x)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"ell_spmv {name} B={batch}: {got.dtype}{tuple(got.shape)} "
                  f"vs plain {want.dtype}{tuple(want.shape)}")
            err = max_err(torch, got, want)
            case_err = max(case_err, err)
            if integer:
                check(torch.equal(got, want),
                      f"ell_spmv {name} B={batch}: max |kernel - plain| = {err}")
            else:
                check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                      f"ell_spmv {name} B={batch}: max |kernel - plain| = {err}")
            if batch is not None:
                check(torch.equal(ell_spmv(*arrs, x, 8), got),
                      f"ell_spmv {name} B={batch}: batch tiles 8 and 32 differ")
        emit({"phase": "kernel_vs_plain", "kernel": "ell_spmv", "values": name,
              "shape": [n, n], "K": int(arrs[0].shape[1]),
              "slots": int(arrs[2].sum()), "max_abs_err": case_err, "ok": True})
        errs["ell_spmv"] = max(errs["ell_spmv"], case_err)
    torch.cuda.empty_cache()


def phase_ell_path(torch, rng, device, records, errs) -> tuple:
    """The ELL path at full width through ``kernels.ell_spmv``."""
    from repro_torch.kernels import ell_spmv, instrument
    from repro_torch.kernels.ell_spmv import _pack_ell, ell_spmv_plain

    by_matrix = {r["matrix"]: r for r in records}
    emit({"phase": "ell_path", "matrix": "scale-free", "skipped": True,
          "why": "its densest row has 2,097,152 nonzeros, so ELL would pad "
                 "every row to K = 2,097,152"})
    cells = []
    for name, K in (("regular", 16), ("block", 48)):
        rec = by_matrix[name]
        rows, cols = rec["shape"]
        t0 = time.perf_counter()
        ri, ci, vals = rec["sm"].coalesced()
        arrs = [t.to(device) for t in _pack_ell(ri, ci, vals, rows, K)]
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        slots = rows * K
        check(int(arrs[2].sum()) == slots == rec["st"].nnz,
              f"ELL {name}: K={K} pads or drops slots")
        cells.append((name, K, rec, arrs, pack_s))
    instrument.reset()
    requests = 0
    for name, K, rec, arrs, pack_s in cells:
        rows, cols = rec["shape"]
        for i in range(10):
            batch = None if i < 8 else 8
            xshape = (cols,) if batch is None else (cols, batch)
            x = torch.from_numpy(rng.integers(-2, 3, xshape).astype(np.float32)
                                 ).to(device)
            y = ell_spmv(*arrs, x)
            requests += 1
            plain, lib = ell_spmv_plain(*arrs, x), rec["A"] @ x
            errs["ell_spmv"] = max(errs["ell_spmv"], max_err(torch, y, plain))
            check(torch.equal(y, plain), f"ELL {name} request {i}: != plain")
            check(torch.equal(y, lib), f"ELL {name} request {i}: != cuSPARSE")
    launches = instrument.launches("ell")
    check(launches == requests, f"ELL launches {launches} != requests {requests}")
    rows_out = {}
    for name, K, rec, arrs, pack_s in cells:
        rows, cols = rec["shape"]
        x = torch.from_numpy(rng.integers(-2, 3, cols).astype(np.float32)
                             ).to(device)
        bound, by, nbytes = ell_bound(rows, K, cols, 1)
        row = {"matrix": name, "K": K, "slots": rows * K, "pack_s": pack_s,
               "ms": time_ms(torch, lambda: ell_spmv(*arrs, x), 30),
               "plain_ms": time_ms(torch, lambda: ell_spmv_plain(*arrs, x), 5,
                                   warmup=1),
               "library_ms": time_ms(torch, lambda: rec["A"] @ x, 30),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes}
        row["roofline_share"] = bound / row["ms"]
        emit({"phase": "ell_times", **row})
        rows_out[name] = row
    emit({"phase": "ell_launch_counts", "launches": launches,
          "requests": requests, "answers": "bit-equal to plain and cuSPARSE"})
    return launches, rows_out


def part_bound(prog, st, batch: int = 1):
    """(bound ms, bound_by): the parts' nonzeros (or blocks), x and the
    per-part y slices moved once."""
    part = prog.mat
    P = part.n_parts
    if part.fmt in ("coo", "csr"):
        nbytes = st.nnz * (8 + 4)
    else:
        r, c = part.block
        nbytes = int(part.nnz.sum()) * (r * c * 4 + 4)
    nbytes += part.shape[1] * batch * 4 + P * part.h_pad * batch * 4
    ops_ = 2 * st.nnz * batch
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_partitioned(torch, rng, device, records, n_ring: int) -> tuple:
    """The partitioned path: P = 16 parts on the card, one part-axis launch
    per request."""
    from repro_torch.api import SparseMatrix, plan_from_partitioned
    from repro_torch.core import distributed as D
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import partition_1d_coalesced
    from repro_torch.kernels import instrument

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    plans = [("regular", dict(scheme="auto")), ("scale-free", dict(scheme="auto")),
             ("block", dict(scheme="auto")), ("regular", dict(scheme="1d.nnz")),
             ("regular", dict(scheme="2d.equally-wide")),
             ("regular", dict(scheme="2d.variable-sized"))]
    built = []
    for name, kw in plans:
        rec = by_matrix[name]
        pln = rec["sm"].plan(devices=[device] * PARTS, **kw)
        exe = pln.compile()
        print(pln.describe(), flush=True)
        built.append((name, pln, exe, rec))
        emit({"phase": "partitioned_plan", "matrix": name, "scheme_id": pln.scheme_id,
              "grid": list(pln.grid), "partition_s": exe.build_seconds,
              "h_pad": exe.part.h_pad, "w_pad": exe.part.w_pad,
              "padding_efficiency": exe.part.padding_efficiency})
    requests = {"coo": 0, "coo.spmm": 0, "bcoo": 0, "bcoo.spmm": 0}
    launches = dict.fromkeys(requests, 0)
    lat = {}
    for name, pln, exe, rec in built:
        kind = "coo" if pln.fmt in ("coo", "csr") else "bcoo"
        shape = rec["shape"]
        xs = [rng.integers(-2, 3, (shape[1],) if i < 16 else
                           (shape[1], (8, 64)[i % 2])).astype(np.float32)
              for i in range(20)]
        # the single-device kernel's answers, launched before this plan's
        # counted requests
        singles = [rec["prog"](torch.from_numpy(x).to(device)) for x in xs]
        lat[(name, pln.scheme_id)] = []
        instrument.reset()
        for i, x in enumerate(xs):
            t0 = time.perf_counter()
            y = exe(x) if x.ndim == 1 else exe.batch(x)
            if x.ndim == 1:
                lat[(name, pln.scheme_id)].append(time.perf_counter() - t0)
            requests[kind] += 1
            requests[kind + ".spmm"] += x.ndim == 2
            check(y.shape == (shape[0],) + x.shape[1:] and np.isfinite(y).all(),
                  f"{name}/{pln.scheme_id}: bad answer shape {y.shape}")
            check(np.array_equal(y, singles[i].cpu().numpy()),
                  f"{name}/{pln.scheme_id} request {i}: != single-device kernel")
            lib = rec["A"] @ torch.from_numpy(x).to(device)
            check(np.array_equal(y, lib.cpu().numpy()),
                  f"{name}/{pln.scheme_id} request {i}: != cuSPARSE")
        for k in launches:
            launches[k] += instrument.launches(k)
        del singles
    emit({"phase": "partitioned_launch_counts", "launches": launches,
          "requests": requests})
    check(launches == requests,
          f"partitioned launch counters {launches} != requests {requests}")

    rows_out = []
    for name, pln, exe, rec in built:
        prog, local = exe.program, exe.program.local
        arrs = D._flat(exe.arrays) if pln.partitioning == "2d" else exe.arrays
        err = 0.0
        for batch in (None, 8):
            xshape = (rec["shape"][1],) if batch is None else (rec["shape"][1],
                                                               batch)
            xb = prog.x_buffer(exe.place(rng.integers(-2, 3, xshape)
                                         .astype(np.float32)))
            got, want = local.raw(arrs, xb), local.plain(arrs, xb)
            torch.cuda.synchronize()
            err = max(err, max_err(torch, got, want))
            check(torch.equal(got, want),
                  f"{name}/{pln.scheme_id} B={batch}: part-axis launch != its "
                  f"per-part plain versions (max err {err})")
        xb = prog.x_buffer(exe.place(rng.integers(-2, 3, rec["shape"][1])
                                     .astype(np.float32)))
        xd = xb[: rec["shape"][1]].contiguous()
        bound, by = part_bound(prog, rec["st"])
        row = {"matrix": name, "scheme_id": pln.scheme_id, "grid": list(pln.grid),
               "kernel": rec["kernel"], "route": kernel_route(rec["prog"], 1),
               "partition_s": exe.build_seconds,
               "exe_ms_p50": 1e3 * statistics.median(lat[(name, pln.scheme_id)]),
               "single_exe_ms_p50": rec["host_ms"],
               "part_ms": time_ms(torch, lambda: local.raw(arrs, xb), 30),
               "single_ms": time_ms(torch, lambda: rec["prog"](xd), 30),
               "part_plain_ms": time_ms(torch, lambda: local.plain(arrs, xb), 3,
                                        warmup=1),
               "library_ms": time_ms(torch, lambda: rec["A"] @ xd, 30),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        emit({"phase": "partitioned_times", **row})
        rows_out.append(row)

    # the 1D ring: torch local kernel only (the reference runs it under xla)
    ri, ci, vals, shape = regular_triplets(rng, n_ring)
    sm = SparseMatrix.from_parts(ri, ci, vals, shape)
    part = partition_1d_coalesced(*sm.triplets(), shape, PARTS, "coo", "nnz")
    part_r, counts = D.bucket_by_source_shard(part, PARTS)
    mesh = make_mesh((PARTS,), ("parts",), [device] * PARTS)
    exe = plan_from_partitioned(part_r, mesh, impl="torch", ring=True,
                                ring_counts=counts, matrix=sm).compile()
    A = library_csr(torch, sm, device)
    instrument.reset()
    t_ring = []
    for i in range(6):
        batch = None if i < 4 else 8
        xshape = (shape[1],) if batch is None else (shape[1], batch)
        x = rng.integers(-2, 3, xshape).astype(np.float32)
        t0 = time.perf_counter()
        y = exe(x)
        t_ring.append(time.perf_counter() - t0)
        check(np.array_equal(y, (A @ torch.from_numpy(x).to(device)).cpu().numpy()),
              f"ring request {i}: != cuSPARSE")
    check(instrument.launches() == 0, "the ring launched a CUDA kernel")
    emit({"phase": "ring", "shape": list(shape), "nnz": sm.nnz,
          "scheme_id": exe.plan.scheme_id, "requests": 6,
          "exe_ms_p50": 1e3 * statistics.median(t_ring),
          "answers": "bit-equal to cuSPARSE"})
    autos = [(name, exe, rec) for (name, pln, exe, rec), (_, kw)
             in zip(built, plans) if kw["scheme"] == "auto"]
    return launches, rows_out, autos


# ------------------------------------------------------------- serving


def pctl(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) if values else 0.0


def served_multiplies(svc) -> int:
    """Engine multiplies a service ran: the batcher's coalesced batches plus
    the explicit batches it served (every served request that did not ride
    the batcher)."""
    mb = svc.batcher
    return mb.batches_run + (svc.served - mb.vectors_run)


def check_launches(svc, what: str) -> dict:
    """The COO + block launches since the last reset equal the engine's
    multiplies: one part-axis launch per coalesced or explicit batch."""
    from repro_torch.kernels import instrument

    got = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    want = served_multiplies(svc)
    recorded = sum(bd["requests"] for bd in svc.engine.telemetry.breakdown().values())
    emit({"phase": "serve_launch_counts", "what": what, "launches": got,
          "batches_run": svc.batcher.batches_run,
          "explicit_batches": svc.served - svc.batcher.vectors_run,
          "engine_multiplies": recorded})
    check(sum(got.values()) == want == recorded,
          f"{what}: launches {got} != multiplies {want} (telemetry {recorded})")
    return got


def make_service(engine):
    from repro_torch.serve import AsyncSpmvService, TenantConfig

    return AsyncSpmvService(engine, tenants={
        t: TenantConfig(priority=c) for t, c in TENANTS.items()})


async def bounded(aw):
    return await asyncio.wait_for(aw, SERVE_WAIT_S)


async def direct_requests(torch, svc, name, rec, rng, device, singles: int) -> int:
    """``singles`` concurrent single vectors (tenants in turn) and explicit
    B=4 and B=8 batches, their payloads made beforehand; every answer
    bit-equal to cuSPARSE on the card.  Emits the burst's latencies, its
    throughput and the widths the engine served."""
    cols = rec["shape"][1]
    tenants = list(TENANTS)
    xs = [rng.integers(-2, 3, cols).astype(np.float32) for _ in range(singles)]
    xs += [rng.integers(-2, 3, (cols, b)).astype(np.float32) for b in (4, 8)]

    async def timed(tenant, x):
        t0 = time.perf_counter()
        y = await svc.multiply(tenant, name, x)
        return y, (time.perf_counter() - t0) * 1e3

    since = len(svc.engine.telemetry.records)
    t0 = time.perf_counter()
    done = await bounded(asyncio.gather(*[
        timed(tenants[i % len(tenants)], x) for i, x in enumerate(xs)]))
    wall_s = time.perf_counter() - t0
    lat = [ms for _, ms in done]
    emit({"phase": "serve_direct", "matrix": name, "requests": len(xs),
          "vectors": singles + 12, "wall_s": wall_s,
          "p50_ms": pctl(lat, 50), "p99_ms": pctl(lat, 99),
          "throughput_rps": len(xs) / wall_s,
          "widths": dict(sorted(collections.Counter(
              r.batch for r in svc.engine.telemetry.records[since:]).items()))})
    for i, (x, (y, _)) in enumerate(zip(xs, done)):
        lib = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
        check(y.shape == lib.shape and np.array_equal(y, lib),
              f"serving {name} request {i} (B={x.shape[1:] or 1}): != cuSPARSE")
    return len(xs)


def trace_rows(svc, start_mark: float, wall_s: float) -> dict:
    """Latency p50/p99 and throughput per matrix of the completed requests
    traced after ``start_mark`` (a trace's extent: admit to deliver)."""
    from repro_torch.obs import trace_summary

    spans = [s for s in svc.tracer.spans() if s.start_s >= start_mark]
    lat = collections.defaultdict(list)
    for t in trace_summary(spans).values():
        if "deliver" in t["phases"]:
            lat[t["label"].split("/", 1)[1]].append(t["total_s"] * 1e3)
    return {name: {"completed": len(v), "p50_ms": pctl(v, 50),
                   "p99_ms": pctl(v, 99), "throughput_rps": len(v) / wall_s}
            for name, v in lat.items()}


def payload_host_ms(trace, by_matrix) -> None:
    """Host time the replay spends making one payload (``request_vector``,
    on the event loop) per width, next to the trace's arrival span: where
    the payloads take longer than the gaps, the replay fires late."""
    from repro_torch.serve import request_vector

    ms = {}
    for b in sorted({r.batch for r in trace}):
        req = next(r for r in trace if r.batch == b)
        cols = by_matrix[req.name]["shape"][1]
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            request_vector(req, cols, integer=True)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[b] = statistics.median(runs)
    total_s = sum(ms[r.batch] for r in trace) / 1e3
    emit({"phase": "serve_payload", "host_ms_by_width": ms,
          "trace_payload_s": total_s, "trace_span_s": trace[-1].t})


def width_rows(torch, engine, since: int, block_shape: dict) -> dict:
    """Per matrix: the batch widths the engine served (telemetry records
    from index ``since``), the launches per kernel route they took, and the
    load / kernel / retrieve split of those requests."""
    from repro_torch.kernels.bcsr_spmv import block_route

    out = {}
    for r in engine.telemetry.records[since:]:
        row = out.setdefault(r.name, {"widths": collections.Counter(),
                                      "routes": collections.Counter(),
                                      "load_s": 0.0, "kernel_s": 0.0,
                                      "retrieve_s": 0.0})
        row["widths"][r.batch] += 1
        shape = block_shape.get(r.name)
        route = ("coo" if shape is None
                 else "bcoo." + block_route(torch.float32, *shape, r.batch))
        row["routes"][route] += 1
        for k in ("load_s", "kernel_s", "retrieve_s"):
            row[k] += getattr(r, k)
    for row in out.values():
        total = row["load_s"] + row["kernel_s"] + row["retrieve_s"]
        row["split"] = {k[:-2]: row[k] / total for k in ("load_s", "kernel_s",
                                                         "retrieve_s")}
        row["widths"] = dict(sorted(row["widths"].items()))
        row["routes"] = dict(row["routes"])
    return out


def block_widths(torch, rng, device, rec) -> list:
    """The block kernel at B = 1, 2, 4, 8 on the main-path block program:
    the route ``block_route`` takes, and the tensor-core route at B = 2 and
    4 for comparison (PERF.md's open question), each bit-equal to the plain
    version before it is timed."""
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv_cuda, block_route

    prog, A, st = rec["prog"], rec["A"], rec["st"]
    rows_, cols = rec["shape"]
    r, c = prog.bvalues.shape[1:]
    out = []
    for batch in (1, 2, 4, 8):
        x = torch.from_numpy(rng.integers(-2, 3, (cols, batch)).astype(np.float32)
                             ).to(device)
        x = x[:, 0].contiguous() if batch == 1 else x
        want = prog.plain(x)
        default = block_route(prog.bvalues.dtype, r, c, batch)
        routes = [default] + (["mma"] if batch in (2, 4) else [])
        nbytes = (prog.nblocks * (r * c * 4 + 4) + prog.browptr.numel() * 4
                  + cols * batch * 4 + rows_ * batch * 4)
        ops_ = 2 * st.nnz * batch
        by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
        for route in routes:
            fn = (lambda: bcoo_spmv_cuda(prog.browptr, prog.bcolind, prog.bvalues,
                                         x, prog.rows, route=route))
            got = fn()
            torch.cuda.synchronize()
            row = {"B": batch, "route": route, "taken_by_engine": route == default,
                   "bit_equal_to_plain": bool(torch.equal(got, want)),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
            if route == default:
                check(row["bit_equal_to_plain"],
                      f"block kernel B={batch} ({route}): != plain version")
            if row["bit_equal_to_plain"]:
                row["ms"] = time_ms(torch, fn, 30)
                row["roofline_share"] = row["bound_ms"] / row["ms"]
            else:
                row["ms"] = "not measured: differs from the plain version"
            if route == default:
                row["plain_ms"] = time_ms(torch, lambda: prog.plain(x), 5, warmup=1)
                row["library_ms"] = time_ms(torch, lambda: A @ x, 30)
            emit({"phase": "block_batcher_widths", **row})
            out.append(row)
    return out


def phase_serving(torch, rng, device, records, seed: int) -> dict:
    """The serving path at full width: engine, batcher, service, replay."""
    from repro_torch.api import SparseMatrix
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.obs.tracing import clock as obs_clock
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    eng = SpmvEngine(cache_capacity=4)  # one part on the card
    for name, rec in by_matrix.items():
        t0 = time.perf_counter()
        entry = eng.register(name, rec["sm"])
        register_s = time.perf_counter() - t0
        cp = eng.plan_for(name)
        check(cp.impl == "cuda" and cp.executor.device.type == device.type,
              f"serving {name}: plan runs {cp.impl} on {cp.executor.device}")
        emit({"phase": "serve_register", "matrix": name, "shape": list(entry.shape),
              "nnz": entry.stats.nnz, "scheme_id": entry.plan.tag,
              "grid": list(entry.plan.grid), "register_s": register_s,
              "placed_bytes": sum(t.numel() * t.element_size()
                                  for t in cp.arrays.values())})
    block_shape = {n: tuple(eng.plan_for(n).part.block) for n in by_matrix
                   if eng.plan_for(n).plan.fmt in ("bcoo", "bcsr")}
    svc = make_service(eng)
    spec = WorkloadSpec(names=tuple(by_matrix), tenants=tuple(TENANTS),
                        n_requests=600, seed=seed, zipf_alpha=1.1, rate_rps=300.0,
                        arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS)
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            direct = 0
            for name, rec in by_matrix.items():
                direct += await direct_requests(torch, svc, name, rec, rng, device, 64)
            since, mark = len(eng.telemetry.records), obs_clock()
            report = await bounded(replay(svc, trace, time_scale=1.0,
                                          integer_values=True))
            return direct, since, mark, report
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    instrument.reset()
    direct, since, mark, report = asyncio.run(run())
    launches = check_launches(svc, "full-width service")
    n_inf = sum(r.infeasible for r in trace)
    emit({"phase": "serve_replay", "requests": report.requests,
          "completed": report.completed, "rejected": report.rejected,
          "reject_reasons": report.reject_reasons, "errors": report.errors,
          "lost": report.lost, "infeasible": n_inf,
          "infeasible_rejected": report.infeasible_rejected,
          "infeasible_served": report.infeasible_served, "wall_s": report.wall_s,
          "throughput_rps": report.throughput_rps, "latency": report.latency,
          "phases": report.phases, "queue_wait": report.queue_wait,
          "direct_requests": direct})
    check(report.lost == 0 and report.errors == 0,
          f"replay lost {report.lost}, errors {report.errors}")
    check(report.infeasible_rejected == n_inf and report.infeasible_served == 0,
          f"replay shed {report.infeasible_rejected} of {n_inf} expired requests")
    payload_host_ms(trace, by_matrix)
    per_matrix = trace_rows(svc, mark, report.wall_s)
    widths = width_rows(torch, eng, since, block_shape)
    for name in by_matrix:
        emit({"phase": "serve_matrix", "matrix": name, **per_matrix.get(name, {}),
              **widths.get(name, {})})
    for cls, d in sorted(report.per_class.items()):
        emit({"phase": "serve_class", "class": cls,
              "throughput_rps": d["completed"] / report.wall_s, **d})

    # eviction: a plan evicted from a one-plan cache frees its card memory
    ev = SpmvEngine(cache_capacity=1)
    ev.register("block", by_matrix["block"]["sm"], warmup=False)
    evicted = ev.plan_for("block")
    placed = sum(t.numel() * t.element_size() for t in evicted.arrays.values())
    ri, ci, vals, shape = regular_triplets(rng, 1 << 16)
    fourth = SparseMatrix.from_parts(ri, ci, vals, shape)
    probe = SpmvEngine(cache_capacity=1)  # the fourth plan's own allocation
    torch.cuda.synchronize()
    m = torch.cuda.memory_allocated()
    probe.register("fourth", fourth, warmup=False)
    torch.cuda.synchronize()
    alloc_fourth = torch.cuda.memory_allocated() - m
    del probe
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    ev.register("fourth", fourth, warmup=False)  # evicts the block plan
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    freed = m0 + alloc_fourth - m1
    emit({"phase": "serve_eviction", "evicted_placed_bytes": placed,
          "freed_bytes": freed, "fourth_plan_bytes": alloc_fourth,
          "evictions": ev.cache.stats.evictions})
    check(ev.cache.stats.evictions == 1 and evicted.arrays is None,
          "eviction: the block plan was not evicted")
    check(freed >= placed, f"eviction freed {freed} bytes < placed {placed}")
    del ev, evicted

    # the same service over 16 parts of the card
    e16 = SpmvEngine(devices=[device] * PARTS)
    rec = by_matrix["regular"]
    entry = e16.register("regular", rec["sm"])
    svc16 = make_service(e16)

    async def run16():
        svc16.start()
        try:
            return await direct_requests(torch, svc16, "regular", rec, rng, device, 16)
        finally:
            await bounded(svc16.aclose())
            svc16.batcher.stop(drain=False)

    instrument.reset()
    n16 = asyncio.run(run16())
    launches16 = check_launches(svc16, f"16-part service {entry.plan.tag}")
    emit({"phase": "serve_parts", "matrix": "regular", "scheme_id": entry.plan.tag,
          "grid": list(entry.plan.grid), "requests": n16,
          "widths": dict(sorted(collections.Counter(
              r.batch for r in e16.telemetry.records).items())),
          "answers": "bit-equal to cuSPARSE"})
    del e16, svc16
    block_widths(torch, rng, device, by_matrix["block"])
    return {k: launches[k] + launches16[k] for k in launches}, eng


def phase_serving_oracle(torch, rng, device, n: int, seed: int) -> dict:
    """A replay at n^2 over the three recipes with dense oracles on the
    card: every completed answer bit-equal."""
    from repro_torch.api import SparseMatrix
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    makers = {"regular": lambda: regular_triplets(rng, n),
              "scale-free": lambda: scale_free_triplets(rng, n, 8 * n),
              "block": lambda: block_triplets(rng, n)}
    eng = SpmvEngine(cache_capacity=4)
    svc = make_service(eng)
    oracles = {}
    for name, make in makers.items():
        ri, ci, vals, shape = make()
        sm = SparseMatrix.from_parts(ri, ci, vals, shape)
        svc.register(None, name, sm)
        dense = torch.zeros(shape, dtype=torch.float32, device=device)
        cri, cci, cv = sm.coalesced()
        dense[cri.to(device), cci.to(device)] = cv.to(device)
        oracles[name] = dense
    spec = WorkloadSpec(names=tuple(makers), tenants=tuple(TENANTS),
                        n_requests=120, seed=seed + 1, rate_rps=300.0,
                        arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS)
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            return await bounded(replay(svc, trace, oracles=oracles, time_scale=0.0,
                                        integer_values=True))
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    instrument.reset()
    report = asyncio.run(run())
    launches = check_launches(svc, f"{n}^2 oracle replay")
    emit({"phase": "serve_oracle_replay", "shape": [n, n],
          "requests": report.requests, "completed": report.completed,
          "rejected": report.rejected, "errors": report.errors, "lost": report.lost,
          "verified": report.verified, "bitexact": report.bitexact,
          "max_abs_err": report.max_abs_err, "oracles": "dense, on the card"})
    check(report.lost == 0 and report.errors == 0,
          f"oracle replay lost {report.lost}, errors {report.errors}")
    check(report.bitexact == report.verified == report.completed > 0,
          f"oracle replay: {report.bitexact} bit-exact of {report.verified} "
          f"verified of {report.completed} completed")
    check(report.infeasible_rejected == sum(r.infeasible for r in trace),
          "oracle replay: an expired request was not shed")
    solver = solver_replay(torch, eng, oracles, makers, seed)
    return launches, solver


# ------------------------------------------------------------- solver sessions


def session_launches(engine, since: int) -> int:
    """Launches the engine's requests since telemetry record ``since`` made:
    one per multiply, ``steps`` per solver session (power sessions spend no
    extra multiply on their start)."""
    return sum(r.steps if r.kind == "solve" else 1
               for r in engine.telemetry.records[since:])


def host_power_ms(exe, x0, steps: int = 10) -> float:
    """ms per step of the host loop a session replaces: ``exe(x)`` (x and y
    cross to the card and back) plus the normalization in numpy."""
    x = x0
    t0 = time.perf_counter()
    for _ in range(steps):
        y = exe(x)
        x = y / max(float(np.linalg.norm(y)), 1e-30)
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_solver(torch, rng, device, records, autos, times) -> dict:
    """Phase 10 (a)-(c): solver sessions through ``exe.iterate`` at full
    width on the card — plain parity, tol mode, per-step times."""
    from repro_torch.api import SparseMatrix
    from repro_torch.kernels import instrument

    launches, want = {"coo": 0, "bcoo": 0}, {"coo": 0, "bcoo": 0}

    def counted(kind, steps, fn):
        instrument.reset()
        out = fn()
        for k in launches:
            launches[k] += instrument.launches(k)
        want[kind] += steps
        return out

    # (a) plain, 3 steps: bit-equal to 3 host exe(x) calls (and, where every
    # partial sum stays below 2^24, to 3 cuSPARSE products)
    plans = [(r["matrix"], r["fmt"], r["exe"], r) for r in records]
    plans += [(name, f"{exe.plan.scheme_id} ({PARTS} parts)", exe, rec)
              for name, exe, rec in autos]
    for name, label, exe, rec in plans:
        n = rec["shape"][1]
        kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
        x0 = rng.integers(-2, 3, n).astype(np.float32)
        x = x0
        for _ in range(3):
            x = exe(x)
        res = counted(kind, 3, lambda: exe.iterate(x0, steps=3, combine="plain"))
        check(res.steps == 3 and res.x.shape == (n,) and np.isfinite(res.x).all(),
              f"solver {name}/{label}: bad session {res.steps} {res.x.shape}")
        check(np.array_equal(res.x, x),
              f"solver {name}/{label}: 3 plain steps != 3 host exe(x) calls")
        lib = None
        if name in ("regular", "block"):
            xd = torch.from_numpy(x0).to(device)
            for _ in range(3):
                xd = rec["A"] @ xd
            lib = bool(np.array_equal(res.x, xd.cpu().numpy()))
            check(lib, f"solver {name}/{label}: 3 plain steps != 3 cuSPARSE products")
        emit({"phase": "solver_plain", "matrix": name, "plan": label, "steps": 3,
              "equal_host_loop": True, "equal_cusparse": lib,
              "kernel_s": res.kernel_s})

    # (b) tol mode: Jacobi on the regular recipe plus 64 on the diagonal
    n = records[0]["shape"][1]
    ri, ci, vals, shape = regular_triplets(rng, n)
    diag_idx = np.arange(n)
    sm = SparseMatrix.from_parts(np.concatenate([ri, diag_idx]),
                                 np.concatenate([ci, diag_idx]),
                                 np.concatenate([vals, np.full(n, 64, np.float32)]),
                                 shape)
    del ri, ci, vals
    cri, cci, cv = sm.coalesced()
    on = cri == cci
    diag = np.zeros(n, np.float32)
    diag[cri[on].numpy()] = cv[on].numpy()
    check(bool((diag >= 62).all()), "jacobi matrix: a diagonal entry below 62")
    exe = sm.plan(scheme="auto", device=device).compile()
    b = rng.integers(-2, 3, n).astype(np.float32)
    kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
    res = exe.iterate(np.zeros(n, np.float32), tol=1e-2, combine="jacobi", b=b,
                      diag=diag, check_every=8, max_steps=200)  # cold, uncounted
    res = counted(kind, res.steps, lambda: exe.iterate(
        np.zeros(n, np.float32), tol=1e-2, combine="jacobi", b=b, diag=diag,
        check_every=8, max_steps=200))
    check(res.converged and res.steps % 8 == 0 and res.steps < 200,
          f"jacobi: converged={res.converged} after {res.steps} steps")
    x = np.zeros(n, np.float32)
    for _ in range(res.steps):
        x = x + (b - exe(x)) / diag
    check(x.dtype == np.float32 and np.array_equal(res.x, x),
          f"jacobi: {res.steps} steps != the numpy float32 host loop")
    emit({"phase": "solver_tol", "matrix": "regular + 64 I", "shape": list(shape),
          "nnz": sm.nnz, "scheme_id": exe.plan.scheme_id, "steps": res.steps,
          "residual": res.residual, "converged": res.converged,
          "per_iter_us": res.per_iter_s * 1e6, "equal_host_loop": True})
    del exe, sm

    # (c) times: 100-step power sessions, cold (first of its loop) and warm
    for rec in records:
        if (rec["matrix"], rec["fmt"]) not in (("regular", "coo"),
                                               ("scale-free", "coo"),
                                               ("block", "bcoo")):
            continue
        exe, n = rec["exe"], rec["shape"][1]
        kind = "coo" if rec["fmt"] == "coo" else "bcoo"
        x0 = rng.integers(-2, 3, n).astype(np.float32)
        sessions = [counted(kind, 100, lambda: exe.iterate(
            x0, steps=100, combine="power")) for _ in range(4)]
        check(sessions[0].compiled and not any(r.compiled for r in sessions[1:]),
              f"solver {rec['matrix']}: the first power session is not the cold one")
        check(all(np.array_equal(r.x, sessions[0].x) for r in sessions)
              and np.isfinite(sessions[0].x).all(),
              f"solver {rec['matrix']}: power sessions disagree")
        warm = [r.per_iter_s * 1e6 for r in sessions[1:]]
        row = {"matrix": rec["matrix"], "fmt": rec["fmt"], "steps": 100,
               "per_iter_us_cold": sessions[0].per_iter_s * 1e6,
               "per_iter_us_warm": statistics.median(warm),
               "per_iter_us_warm_runs": warm,
               "load_ms_warm": sessions[-1].load_s * 1e3,
               "retrieve_ms_warm": sessions[-1].retrieve_s * 1e3,
               "kernel_ms_b1": times[(rec["matrix"], rec["fmt"], 1)]["ms"],
               "host_loop_ms_per_step": host_power_ms(exe, x0)}
        emit({"phase": "solver_times", **row})
    emit({"phase": "solver_launch_counts", "launches": launches,
          "steps": want})
    check(launches == want, f"solver launches {launches} != steps {want}")
    return launches


def phase_solver_service(torch, rng, device, engine, records) -> dict:
    """Phase 10 (d): four concurrent 20-step power sessions per matrix on
    phase 8's engine, under a burst of 64 single multiplies on the same
    matrix; multiplies bit-equal to cuSPARSE, sessions within 1e-4 of a
    float64 power loop (cuSPARSE in float64 on the card)."""
    from repro_torch.kernels import instrument

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    svc = make_service(engine)
    tenants = list(TENANTS)
    work = {}
    for name, rec in by_matrix.items():
        cols = rec["shape"][1]
        work[name] = ([rng.standard_normal(cols).astype(np.float32)
                       for _ in range(4)],
                      [rng.integers(-2, 3, cols).astype(np.float32)
                       for _ in range(64)])

    async def run():
        svc.start()
        try:
            out = {}
            for name, (x0s, xs) in work.items():
                coros = [svc.solve(tenants[i % 3], name, x0, steps=20,
                                   combine="power") for i, x0 in enumerate(x0s)]
                coros += [svc.multiply(tenants[i % 3], name, x)
                          for i, x in enumerate(xs)]
                t0 = time.perf_counter()
                done = await bounded(asyncio.gather(*coros))
                out[name] = (done, time.perf_counter() - t0)
            return out
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    since = len(engine.telemetry.records)
    instrument.reset()
    out = asyncio.run(run())
    launches = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    recs = engine.telemetry.records[since:]
    expect = session_launches(engine, since)
    emit({"phase": "solver_serve_launch_counts", "launches": launches,
          "multiplies": sum(r.kind == "multiply" for r in recs),
          "session_steps": sum(r.steps for r in recs if r.kind == "solve")})
    check(sum(launches.values()) == expect,
          f"solver service: launches {launches} != multiplies + steps {expect}")
    max_err = 0.0
    for name, (done, wall_s) in out.items():
        rec = by_matrix[name]
        x0s, xs = work[name]
        mine = [r for r in recs if r.name == name]
        solves = [r for r in mine if r.kind == "solve"]
        check(len(solves) == 4 and all(r.steps == 20 for r in solves),
              f"solver service {name}: solve records {[r.steps for r in solves]}")
        for i, (x, y) in enumerate(zip(xs, done[4:])):
            lib = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
            check(np.array_equal(y, lib),
                  f"solver service {name} multiply {i}: != cuSPARSE")
        csr = rec["A"]
        A64 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      csr.values().double(), size=csr.shape)
        for i, (x0, res) in enumerate(zip(x0s, done[:4])):
            x = torch.from_numpy(x0).to(device, torch.float64)
            for _ in range(20):
                y = A64 @ x
                x = y / max(float(torch.linalg.vector_norm(y)), 1e-30)
            err = float(np.abs(res.x.astype(np.float64) - x.cpu().numpy()).max())
            max_err = max(max_err, err)
            check(res.steps == 20 and err <= 1e-4,
                  f"solver service {name} session {i}: max err {err} vs float64")
        del A64
        muls = [r for r in mine if r.kind == "multiply"]
        split = {k: sum(getattr(r, k + "_s") for r in muls)
                 for k in ("load", "kernel", "retrieve")}
        total = sum(split.values())
        emit({"phase": "solver_serve", "matrix": name, "sessions": 4,
              "multiplies": len(muls), "wall_s": wall_s,
              "widths": dict(sorted(collections.Counter(
                  r.batch for r in muls).items())),
              "multiply_split": {k: v / total for k, v in split.items()},
              "multiply_kernel_ms_mean": split["kernel"] * 1e3 / len(muls),
              "session_per_iter_us": [r.per_iter_s * 1e6 for r in solves],
              "session_ms": [r.total_s * 1e3 for r in solves],
              "sessions_max_abs_err_vs_f64": max_err})
    snap = svc.metrics.snapshot()
    emit({"phase": "solver_serve_metrics",
          "per_iter_us": snap.get("serve.solve.per_iter_us"),
          "e2e_ms": snap.get("serve.solve.e2e_ms")})
    return launches


def solver_replay(torch, eng, oracles, makers, seed: int) -> dict:
    """Phase 10 (e): a replay with 30 % six-step power sessions over phase
    9's engine and dense oracles: every completed session verified."""
    from repro_torch.kernels import instrument
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    svc = make_service(eng)
    spec = WorkloadSpec(names=tuple(makers), tenants=tuple(TENANTS),
                        n_requests=120, seed=seed + 2, rate_rps=300.0,
                        arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS,
                        solve_frac=0.3, solve_steps=6, solve_combine="power")
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            return await bounded(replay(svc, trace, oracles=oracles, time_scale=0.0,
                                        integer_values=True))
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    since = len(eng.telemetry.records)
    instrument.reset()
    report = asyncio.run(run())
    launches = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    expect = session_launches(eng, since)
    emit({"phase": "solver_oracle_replay", "requests": report.requests,
          "completed": report.completed, "rejected": report.rejected,
          "errors": report.errors, "lost": report.lost,
          "sessions": sum(r.is_solve for r in trace), "solves": report.solves,
          "solve_iters": report.solve_iters,
          "solve_per_iter_us": report.solve_per_iter_us,
          "verified": report.verified, "bitexact": report.bitexact,
          "max_abs_err": report.max_abs_err, "launches": launches,
          "oracles": "dense, on the card"})
    check(report.lost == 0 and report.errors == 0,
          f"solver replay lost {report.lost}, errors {report.errors}")
    check(report.solves > 0 and report.verified == report.completed,
          f"solver replay: {report.verified} verified of {report.completed} "
          f"completed ({report.solves} sessions)")
    check(report.bitexact >= report.completed - report.solves
          and report.max_abs_err <= 1e-4,
          f"solver replay: {report.bitexact} bit-exact, max err {report.max_abs_err}")
    check(sum(launches.values()) == expect,
          f"solver replay: launches {launches} != multiplies + steps {expect}")
    return launches


# ------------------------------------------------------------- tuning


def total_launches(instrument) -> int:
    """Kernel launches of both kernels of the tuning path (the ``.spmm``
    keys count a subset again)."""
    return instrument.launches("coo") + instrument.launches("bcoo")


def add_launches(into: dict, instrument) -> dict:
    for k in into:
        into[k] += instrument.launches(k)
    return into


def kernel_fn(torch, exe, x, device):
    """The compiled program's kernel alone on input ``x``: the single-device
    kernel program, or the part-axis launch of a mesh executor."""
    if not exe.plan.is_distributed:
        prog = exe.program
        xd = torch.as_tensor(x).to(device)
        return lambda: prog(xd)
    from repro_torch.core import distributed as D

    prog, local = exe.program, exe.program.local
    arrs = D._flat(exe.arrays) if exe.plan.partitioning == "2d" else exe.arrays
    xb = prog.x_buffer(exe.place(x))
    return lambda: local.raw(arrs, xb)


def timed_measurer(torch, device):
    """The reference Measurer (warmup 2, iters 5, trim 1) that also times
    each candidate's kernel with CUDA events on the program it compiled,
    before measuring it, and logs every measurement and every exception."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import Measurer

    class Timed(Measurer):
        def __init__(self):
            super().__init__()
            self.log, self.errors, self.timing_launches = [], [], 0

        def measure(self, plan, x):
            try:
                return super().measure(plan, x)
            except Exception as e:
                self.errors.append(f"{plan.scheme_id}: {type(e).__name__}: {e}")
                emit({"phase": "tune_error", "scheme_id": plan.scheme_id,
                      "error": self.errors[-1]})
                raise

        def _time(self, plan, exe, x, compile_s):
            n0 = total_launches(instrument)
            ms = time_ms(torch, kernel_fn(torch, exe, x, device), 20, warmup=2)
            self.timing_launches += total_launches(instrument) - n0
            m = super()._time(plan, exe, x, compile_s)
            self.log.append((m, ms))
            return m

    return Timed()


def winner_check(torch, exe, rec, device, rng, batch, what: str) -> None:
    """The winner's answers on an integer-valued x: bit-equal to cuSPARSE
    and to the plain version of the single-device kernel."""
    cols = rec["shape"][1]
    x = rng.integers(-2, 3, (cols,) if batch is None else (cols, batch)) \
        .astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    y = exe(x)
    check(np.array_equal(y, (rec["A"] @ xd).cpu().numpy()),
          f"{what}: tuned winner != cuSPARSE")
    check(np.array_equal(y, rec["prog"].plain(xd).cpu().numpy()),
          f"{what}: tuned winner != plain version")


def tune_rows(what: dict, pln, timed) -> dict:
    """Emit one line per measured candidate and one for the tune: the
    winner, the analytic pick, and the candidates ranked by ``mean_s``
    (what the tuner ranks by: exe(x) with both copies) and by kernel ms."""
    log = timed.log
    by_mean = sorted(range(len(log)), key=lambda i: log[i][0].mean_s)
    by_kernel = sorted(range(len(log)), key=lambda i: log[i][1])
    for i, (m, ms) in enumerate(log):
        emit({"phase": "tune_candidate", **what, "scheme_id": m.scheme_id,
              "impl": m.impl, "grid": list(m.grid), "fmt": m.fmt,
              "mean_s": m.mean_s, "times_s": list(m.times_s),
              "compile_s": m.compile_s, "phases": m.phases, "kernel_ms": ms,
              "rank_by_mean": by_mean.index(i), "rank_by_kernel": by_kernel.index(i)})
    row = {"phase": "tune", **what, "winner": pln.scheme_id,
           "winner_fmt": pln.fmt, "analytic": pln.measured["baseline_scheme_id"],
           "speedup": pln.measured["speedup"], "measured": len(log),
           "fastest_kernel": log[by_kernel[0]][0].scheme_id,
           "fastest_kernel_fmt": log[by_kernel[0]][0].fmt,
           "rankings_agree": by_mean == by_kernel,
           "winner_fmt_has_fastest_kernel":
               pln.fmt == log[by_kernel[0]][0].fmt}
    emit(row)
    return row


def phase_tune_single(torch, rng, device, by_matrix, path) -> tuple:
    """Phase 11 (a) and (b): single-device tuning at full width, B=1 on all
    three matrices and B=8 on block and regular, into one cache file; then
    the same tunes again from the file, measuring nothing."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import CandidateGenerator, Tuner, TuningCache

    runs = [(name, None) for name in by_matrix] + [("block", 8), ("regular", 8)]
    launches, rows = {"coo": 0, "bcoo": 0}, []
    for name, batch in runs:
        rec = by_matrix[name]
        sm = rec["sm"]
        planned = CandidateGenerator().plans(sm, device=device)
        timed = timed_measurer(torch, device)
        instrument.reset()
        t0 = time.perf_counter()
        pln = sm.plan(scheme="tune", device=device, batch=batch,
                      tuner=Tuner(measurer=timed, cache=TuningCache(path)))
        wall_s = time.perf_counter() - t0
        n = total_launches(instrument)
        add_launches(launches, instrument)
        what = {"matrix": name, "B": batch or 1}
        row = tune_rows(what, pln, timed)
        row.update(planned=len(planned), wall_s=wall_s, launches=n)
        rows.append(row)
        check(not timed.errors, f"tune {what}: candidates raised {timed.errors}")
        check(len(timed.log) == len(planned) == pln.measured["candidates"],
              f"tune {what}: measured {len(timed.log)} of {len(planned)} planned")
        expect = len(planned) * (timed.warmup + timed.iters) + timed.timing_launches
        check(n == expect, f"tune {what}: {n} launches != measured calls + "
              f"kernel timing {expect}")
        check(not pln.is_distributed and pln.impl == "cuda",
              f"tune {what}: winner {pln.describe()}")
        exe = pln.compile()
        winner_check(torch, exe, rec, device, rng, batch, f"tune {what}")
        exe.release()
        del exe
    # (b) the same tunes from the file: no measurement, no launch
    for row in rows:
        cache, timed = TuningCache(path), timed_measurer(torch, device)
        instrument.reset()
        pln = by_matrix[row["matrix"]]["sm"].plan(
            scheme="tune", device=device, batch=row["B"],
            tuner=Tuner(measurer=timed, cache=cache))
        hit = {"phase": "tune_cache_hit", "matrix": row["matrix"], "B": row["B"],
               "hits": cache.hits, "misses": cache.misses,
               "measured": len(timed.log), "launches": total_launches(instrument),
               "scheme_id": pln.scheme_id, "from_cache": pln.measured["from_cache"]}
        emit(hit)
        check(cache.misses == 0 and cache.hits == 1 and not timed.log
              and hit["launches"] == 0 and pln.measured["from_cache"]
              and pln.scheme_id == row["winner"],
              f"second tune from the cache file measured or changed: {hit}")
    cache = TuningCache(path)  # the tune_cache= route, with its default tuner
    pln = by_matrix["scale-free"]["sm"].plan(scheme="tune", tune_cache=path,
                                             device=device)
    check(pln.measured["from_cache"], "tune_cache= did not read the cache file")
    emit({"phase": "tune_cache_file", "entries": len(cache),
          "keys": sorted(cache.export())})
    return launches, rows


def phase_tune_parts(torch, rng, device, rec, path) -> tuple:
    """Phase 11 (c): tuning on 16 parts of the card (scale-free, whose
    partition is the cheapest): load / kernel / retrieve per candidate, the
    kernel phase no shorter than its part-axis launch by CUDA events."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import CandidateGenerator, Tuner, TuningCache

    sm = rec["sm"]
    planned = CandidateGenerator().plans(sm, devices=[device] * PARTS)
    timed = timed_measurer(torch, device)
    instrument.reset()
    t0 = time.perf_counter()
    pln = sm.plan(scheme="tune", devices=[device] * PARTS,
                  tuner=Tuner(measurer=timed, cache=TuningCache(path)))
    wall_s = time.perf_counter() - t0
    n = total_launches(instrument)
    launches = add_launches({"coo": 0, "bcoo": 0}, instrument)
    what = {"matrix": "scale-free", "B": 1, "parts": PARTS}
    row = tune_rows(what, pln, timed)
    row.update(planned=len(planned), wall_s=wall_s, launches=n)
    check(not timed.errors, f"tune {what}: candidates raised {timed.errors}")
    check(len(timed.log) == len(planned) == pln.measured["candidates"],
          f"tune {what}: measured {len(timed.log)} of {len(planned)} planned")
    check(n == len(planned) * (timed.warmup + timed.iters) + timed.timing_launches,
          f"tune {what}: {n} launches")
    for m, ms in timed.log:
        check(set(m.phases) == {"load", "kernel", "retrieve"}
              and all(v > 0 for v in m.phases.values()),
              f"tune {what} {m.scheme_id}: phases {m.phases}")
        check(m.phases["kernel"] * 1e3 >= ms,
              f"tune {what} {m.scheme_id}: kernel phase "
              f"{m.phases['kernel'] * 1e3} ms < part-axis launch {ms} ms")
    exe = pln.compile()
    winner_check(torch, exe, rec, device, rng, None, f"tune {what}")
    exe.release()
    return launches, row


def phase_tune_engine(torch, rng, device, by_matrix) -> tuple:
    """Phase 11 (d): ``SpmvEngine(tune=True, tune_after=8)`` over the three
    matrices.  A client thread multiplies all through; the main thread
    serves 8 width-1 multiplies per matrix (one ``traffic`` refinement
    each), then width 8 until each matrix has a ``drift`` refinement.
    Every answer is bit-equal to cuSPARSE; launches equal the multiplies
    plus each refinement's measured calls and its winner's warm-up."""
    import threading

    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument

    eng = SpmvEngine(tune=True, tune_after=8)
    for name, rec in by_matrix.items():
        eng.register(name, rec["sm"])
    pools = {}  # (matrix, width) -> [(x, cuSPARSE answer)]
    for name, rec in by_matrix.items():
        cols = rec["shape"][1]
        for width in (1, 8):
            xs = [rng.integers(-2, 3, (cols,) if width == 1 else (cols, width))
                  .astype(np.float32) for _ in range(3)]
            pools[(name, width)] = [
                (x, (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy())
                for x in xs]
    state = {"width": 1, "errors": [], "served": 0}
    stop = threading.Event()

    def ask(name, i):
        x, want = pools[(name, state["width"])][i % 3]
        y = eng.multiply(name, x)
        if not np.array_equal(y, want):
            state["errors"].append(f"{name} width {x.shape[1:] or 1}: != cuSPARSE")

    def client():
        i = 0
        try:
            while not stop.is_set():
                ask(list(by_matrix)[i % 3], i)
                i += 1
        except Exception as e:  # reported by the check below
            state["errors"].append(f"client: {type(e).__name__}: {e}")

    instrument.reset()
    since = len(eng.telemetry.records)
    thread = threading.Thread(target=client, name="tune-client")
    t0 = time.perf_counter()
    thread.start()
    try:
        for i in range(8):
            for name in by_matrix:
                ask(name, i)
        eng.drain_tuning(timeout=SERVE_WAIT_S)
        traffic_s = time.perf_counter() - t0
        state["width"] = 8
        for i in range(200):
            if all(any(e["name"] == n and e["trigger"] == "drift"
                       for e in eng.tune_events) for n in by_matrix):
                break
            for name in by_matrix:
                ask(name, i)
            eng.drain_tuning(timeout=SERVE_WAIT_S)
    finally:
        stop.set()
        thread.join(SERVE_WAIT_S)
    eng.drain_tuning(timeout=SERVE_WAIT_S)
    wall_s = time.perf_counter() - t0
    check(not thread.is_alive(), "tune engine: client thread still running")
    multiplies = len(eng.telemetry.records) - since
    got = total_launches(instrument)
    events = list(eng.tune_events)
    expect = multiplies + sum(e["candidates"] * 4 + e["swapped"] for e in events)
    for e in events:
        emit({"phase": "tune_event", **e})
    emit({"phase": "tune_engine", "multiplies": multiplies, "launches": got,
          "expected_launches": expect, "events": len(events),
          "traffic_s": traffic_s, "wall_s": wall_s,
          "plans": {n: eng.registry.get(n).plan.tag for n in by_matrix},
          "errors": state["errors"][:5]})
    check(not state["errors"], f"tune engine: {state['errors'][:5]}")
    for name in by_matrix:
        mine = [e for e in events if e["name"] == name]
        check(not any("error" in e for e in mine), f"tune engine {name}: {mine}")
        check(all(e["candidates"] == e["planned"] for e in mine),
              f"tune engine {name}: a candidate was planned but not measured: {mine}")
        check(sum(e["trigger"] == "traffic" for e in mine) == 1
              and any(e["trigger"] == "drift" for e in mine),
              f"tune engine {name}: triggers {[e['trigger'] for e in mine]}")
    check(got == expect, f"tune engine: launches {got} != multiplies + "
          f"measurements + warm-ups {expect}")
    del eng
    return add_launches({"coo": 0, "bcoo": 0}, instrument)


def phase_tune_suite(torch, rng, device) -> tuple:
    """Phase 11 (f): the tuner over ``paper_large_suite()`` from the port's
    data module (22 matrices at 2048^2): every winner within 2e-4 of the
    dense product.  A correctness sweep: at this size the times are host
    overhead, not kernel times."""
    from repro_torch.api import SparseMatrix
    from repro_torch.data.matrices import paper_large_suite
    from repro_torch.kernels import instrument

    instrument.reset()
    t0 = time.perf_counter()
    winners, worst = {}, 0.0
    for spec in paper_large_suite():
        a = spec.build()
        pln = SparseMatrix.from_dense(a).plan(scheme="tune", device=device)
        exe = pln.compile()
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y, want = exe(x), a.astype(np.float64) @ x
        err = float(np.abs(y - want).max())
        worst = max(worst, err)
        check(np.allclose(y, want, rtol=2e-4, atol=2e-4),
              f"suite {spec.name}: tuned {pln.scheme_id} max err {err}")
        winners[spec.name] = [spec.cls, pln.scheme_id, pln.measured["candidates"]]
        exe.release()
    launches = add_launches({"coo": 0, "bcoo": 0}, instrument)
    emit({"phase": "tune_suite", "matrices": len(winners), "max_abs_err": worst,
          "wall_s": time.perf_counter() - t0, "launches": launches,
          "winners": winners,
          "note": "2048^2 matrices: a correctness sweep; times are host overhead"})
    return launches


def phase_tuning(torch, rng, device, records) -> dict:
    """Phase 11: tuning on the card, (a)-(f); returns the tuning path's
    launches per kernel kind (measurements, kernel timing, engine
    multiplies and refinements, the suite)."""
    import shutil
    import tempfile

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tune-", dir=os.path.join(ROOT, "build"))
    path = os.path.join(tmp, "tune.json")
    seconds, parts = {}, []
    try:
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        parts.append(phase_tune_single(torch, rng, device, by_matrix, path)[0])
        seconds["single_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        parts.append(phase_tune_parts(torch, rng, device, by_matrix["scale-free"],
                                      path)[0])
        seconds["parts_s"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        emit({"phase": "tune_memory", "before_bytes": mem0, "after_bytes": mem1})
        check(mem1 == mem0, f"tuning left {mem1 - mem0} bytes on the card")
        t1 = time.perf_counter()
        parts.append(phase_tune_engine(torch, rng, device, by_matrix))
        seconds["engine_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        parts.append(phase_tune_suite(torch, rng, device))
        seconds["suite_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(p[k] for p in parts) for k in ("coo", "bcoo")}
    emit({"phase": "tuning_done", "seconds": time.perf_counter() - t0,
          "launches": launches, **seconds})
    return launches


# ------------------------------------------------------------- topology

TOPO_SHAPES = ((2, 2), (4, 4))  # the pim_like presets of phase 13 (b)
MODELLED = "modelled on the preset's declared links, not a time on any device"


def topo_requests(torch, rng, device, exe, rec, others=(), n1: int = 6,
                  n8: int = 2) -> tuple:
    """Serve n1 B=1 and n8 B=8 integer-valued requests through ``exe``,
    each bit-equal to the single-device kernel, cuSPARSE and every
    executor of ``others`` (all launched before the counted window).
    Returns (launches, B=1 latencies): one part-axis launch per request."""
    from repro_torch.kernels import instrument

    cols = rec["shape"][1]
    xs = [rng.integers(-2, 3, (cols,) if i < n1 else (cols, 8))
          .astype(np.float32) for i in range(n1 + n8)]
    wants = []
    for x in xs:
        xd = torch.from_numpy(x).to(device)
        want = rec["prog"](xd).cpu().numpy()
        check(np.array_equal(want, (rec["A"] @ xd).cpu().numpy()),
              f"{rec['matrix']}: single-device kernel != cuSPARSE")
        for other in others:
            got = other(x) if x.ndim == 1 else other.batch(x)
            check(np.array_equal(got, want), f"{rec['matrix']} "
                  f"{other.plan.scheme_id}: != single-device kernel")
        wants.append(want)
    kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
    lat = []
    instrument.reset()
    for x, want in zip(xs, wants):
        t0 = time.perf_counter()
        y = exe(x) if x.ndim == 1 else exe.batch(x)
        if x.ndim == 1:
            lat.append(time.perf_counter() - t0)
        check(np.array_equal(y, want), f"{rec['matrix']} {exe.plan.scheme_id} "
              f"B={x.shape[1:] or 1}: != single-device kernel and cuSPARSE")
    got = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    want_l = {"coo": 0, "bcoo": 0, kind: len(xs)}
    check(got == want_l, f"{rec['matrix']} {exe.plan.scheme_id}: launches "
          f"{got} != one part-axis launch per request {want_l}")
    return got, lat


def topo_row(torch, rng, device, exe, rec, lat) -> dict:
    """The placed plan's part-axis launch timed at B=1 beside its bound and
    cuSPARSE, with its partition s and exe(x) p50."""
    pln = exe.plan
    cols = rec["shape"][1]
    x = rng.integers(-2, 3, cols).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    bound, by = part_bound(exe.program, rec["st"])
    ta = pln.topo_assignment
    return {"matrix": rec["matrix"], "scheme_id": pln.scheme_id,
            "grid": list(pln.grid), "kernel": rec["kernel"],
            "assignment": ta and ",".join(
                f"{l}={'*'.join(g) or '-'}"
                for l, g in zip(ta["logical"], ta["physical"])),
            "slots": exe.mesh.slots.reshape(-1).tolist(),
            "modelled_transfer_s": ta and ta["transfer"],
            "modelled_note": MODELLED,
            "partition_s": exe.build_seconds,
            "exe_ms_p50": 1e3 * statistics.median(lat),
            "part_ms": time_ms(torch, kernel_fn(torch, exe, x, device), 30),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(torch, lambda: rec["A"] @ xd, 30)}


def phase_topology(torch, rng, device, records, autos) -> dict:
    """Phase 13: topology-aware placement (``repro_torch.topo``) at full
    width on the card, on phase 3's matrices; returns its launches."""
    from repro_torch.api import plan_from_ir, resolve_scheme
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.topo import (CollectiveCostModel, FakeTopology,
                                  detect_topology)
    from repro_torch.tune import (CandidateGenerator, Measurer, Tuner,
                                  TuningCache, make_key)

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    launches = {"coo": 0, "bcoo": 0}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    # (a) the detector: one flat axis; 16 parts of the regular matrix under
    # it answer as phase 7's flat plan
    here, many = detect_topology(), detect_topology([device.type] * PARTS)
    emit({"phase": "topo_detect", "default": [here.name, list(here.axis_sizes)],
          "cuda16": [many.name, list(many.axis_sizes)]})
    check((here.name, here.axis_sizes) == ("cuda:flat", (1,))
          and (many.name, many.axis_sizes) == ("cuda:flat", (PARTS,)),
          f"detector: {here} / {many}")
    rec = by_matrix["regular"]
    flat = next(exe for name, exe, _ in autos if name == "regular")
    for scheme in ("auto", "2d"):
        exe = rec["sm"].plan(scheme=scheme, topology=many).compile()
        got, lat = topo_requests(torch, rng, device, exe, rec, others=(flat,))
        count(got)
        emit({"phase": "topo_detect_plan", "scheme": scheme,
              "scheme_id": exe.plan.scheme_id, "grid": list(exe.plan.grid),
              "flat_scheme_id": flat.plan.scheme_id,
              "flat_grid": list(flat.plan.grid),
              "answers": "bit-equal to phase 7's flat plan, the single-device "
                         "kernel and cuSPARSE"})
        exe.release()

    # (b) the model's picks under the two presets, "2d" and auto
    kept = {}  # pim2x2's "2d" picks of block and regular, for (c)
    for shape2d in TOPO_SHAPES:
        n = shape2d[0] * shape2d[1]
        topo = FakeTopology.pim_like(shape2d, devices=[device.type] * n)
        for name, rec in by_matrix.items():
            built = {}
            for scheme in ("2d", "auto"):
                fmt = rec["fmt"] if scheme == "2d" else None
                pln = rec["sm"].plan(scheme=scheme, fmt=fmt, topology=topo)
                flat_grid = resolve_scheme(rec["st"], rec["shape"], n, scheme,
                                           fmt=fmt).grid
                key = (pln.scheme_id, pln.grid)
                if key not in built:
                    print(pln.describe(), flush=True)
                    exe = pln.compile()
                    got, lat = topo_requests(torch, rng, device, exe, rec)
                    count(got)
                    built[key] = topo_row(torch, rng, device, exe, rec, lat)
                    if (n, scheme) == (4, "2d") and name != "scale-free":
                        kept[name] = exe
                    else:
                        exe.release()
                emit({"phase": "topo_pick", "topology": topo.name,
                      "scheme": scheme, "flat_grid": list(flat_grid),
                      **built[key]})

    # (c) every assignment of pim2x2 on the (2, 2) grid: y identical, slots
    # the device order of arange(4), kernel ms side by side
    topo = FakeTopology.pim_like((2, 2), devices=[device.type] * 4)
    abstract = FakeTopology.pim_like((2, 2))
    placed = {}
    for name in ("block", "regular"):
        rec = by_matrix[name]
        base = rec["sm"].plan(scheme="2d", fmt=rec["fmt"], grid=(2, 2),
                              topology=topo)
        ranked = CollectiveCostModel(topo).rank(
            base.scheme, rec["shape"], rec["sm"].dtype.itemsize, base.axes)
        check(len(ranked) == 2, f"{name}: assignments {ranked}")
        xs = [rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
              for _ in range(2)]
        ys, rows = [], []
        for a, price in ranked:
            reuse = kept.get(name)
            if reuse is not None and reuse.plan.scheme_id.endswith("@" + a.tag):
                exe = kept.pop(name)  # (b) built this placement already
            else:
                exe = rec["sm"].plan(scheme="2d", fmt=rec["fmt"], grid=(2, 2),
                                     topology=topo, assignment=a).compile()
            want_slots = abstract.device_order(a, devices=range(4))
            check(exe.mesh.slots.reshape(-1).tolist() == want_slots,
                  f"{name} {a.tag}: slots {exe.mesh.slots} != {want_slots}")
            check(exe.plan.scheme_id.endswith("@" + a.tag),
                  f"{name}: {exe.plan.scheme_id} lacks @{a.tag}")
            got, lat = topo_requests(torch, rng, device, exe, rec, n1=4, n8=1)
            count(got)
            ys.append([exe(x) for x in xs])  # compared, not counted
            row = topo_row(torch, rng, device, exe, rec, lat)
            emit({"phase": "topo_forced", "topology": topo.name, **row})
            rows.append(row)
            if name == "block" and a is ranked[-1][0]:
                placed[name] = exe  # the worst placement: phase 13 (d)
            else:
                exe.release()
        check(all(np.array_equal(u, v) for y in ys[1:] for u, v in zip(ys[0], y)),
              f"{name}: answers differ between assignments")
        ms = [r["part_ms"] for r in rows]
        emit({"phase": "topo_forced_spread", "matrix": name,
              "part_ms": ms, "spread": max(ms) / min(ms) - 1.0,
              "answers": "identical across assignments"})
    for exe in kept.values():
        exe.release()

    # (d) the plan IR: the worst placement of the block matrix, round trip
    exe = placed.pop("block")
    rec = by_matrix["block"]
    ir = json.loads(json.dumps(exe.plan.to_ir()))
    check(ir["topo"] and ir["topo"]["topology"] == "pim2x2", f"IR topo {ir['topo']}")
    x = rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
    y = exe(x)
    for how, kw in (("with topology", {"topology": topo}), ("without", {})):
        back = plan_from_ir(ir, rec["sm"], device=device,
                            devices=[device] * 4, **kw).compile()
        slots = back.mesh.slots.reshape(-1).tolist()
        want_slots = (exe.mesh.slots.reshape(-1).tolist() if kw
                      else list(range(4)))  # no topology: flat, as JAX lays it
        check(back.plan.scheme_id == exe.plan.scheme_id,
              f"IR {how}: {back.plan.scheme_id} != {exe.plan.scheme_id}")
        check(slots == want_slots, f"IR {how}: slots {slots} != {want_slots}")
        check(back.plan.to_ir()["topo"] == ir["topo"], f"IR {how}: topo lost")
        instrument.reset()
        check(np.array_equal(back(x), y), f"IR {how}: answers differ")
        count({k: instrument.launches(k) for k in launches})
        emit({"phase": "topo_ir", "how": how, "scheme_id": back.plan.scheme_id,
              "slots": slots, "answers": "bit-equal to the placed plan"})
        back.release()
    exe.release()

    # (e) tuning under pim2x2 on the block matrix at B=1
    rec = by_matrix["block"]
    # four candidates: the first two schemes, each under both assignments
    tuner = Tuner(generator=CandidateGenerator(max_candidates=4),
                  measurer=Measurer(warmup=1, iters=3), cache=TuningCache())
    instrument.reset()
    eng = SpmvEngine(devices=[device.type] * 4, topology=topo, tune=True,
                     tuner=tuner)
    eng.register("block", rec["sm"])
    xs = [rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
          for _ in range(4)]
    for x in xs:
        want = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
        check(np.array_equal(eng.multiply("block", x), want),
              "topo engine: != cuSPARSE")
    t0 = time.perf_counter()
    event = eng.refine("block", x=xs[0])
    tune_s = time.perf_counter() - t0
    key = make_key(rec["sm"], devices=eng.devices, impls=tuner.generator.impls,
                   block=eng.block, topology=topo)
    record = tuner.cache.get(key)
    check(record is not None and key.topology == "cuda:4|pim2x2:2x2",
          f"topo tune key {key.encode()}")
    groups = {}
    for c in record["candidates"]:
        sid, _, tag = c["scheme_id"].partition("@")
        groups.setdefault((sid, tuple(c["grid"])), set()).add(tag)
    grid = tuple(eng.registry.get("block").plan.grid)
    complete = []
    for (sid, g), tags in groups.items():
        axes = ("parts",) if sid.startswith("1d") else ("rows", "cols")
        n_alt = len(topo.assignments(g[:1] if sid.startswith("1d") else g, axes))
        complete.append(len(tags) == n_alt)
        emit({"phase": "topo_tune_group", "scheme": sid, "grid": list(g),
              "assignments_measured": sorted(tags), "assignments": n_alt})
    for c in record["candidates"]:
        emit({"phase": "topo_tune_candidate", **c})
    # the generator's cap may cut the last scheme's assignments short
    capped = len(record["candidates"]) >= tuner.generator.max_candidates
    check(complete and all(complete[:-1]) and (complete[-1] or capped),
          f"topo tune: not one candidate per assignment: {groups}")
    y = eng.multiply("block", xs[1])
    got = total_launches(instrument)
    count({k: instrument.launches(k) for k in launches})
    xd = torch.from_numpy(xs[1]).to(device)  # compared, not counted
    check(np.array_equal(y, (rec["A"] @ xd).cpu().numpy())
          and np.array_equal(y, rec["prog"](xd).cpu().numpy()),
          "topo tune: the winner != cuSPARSE / single-device kernel")
    # the registration's warm-up, 5 multiplies, 4 calls per measured
    # candidate (warmup 1, iters 3) and a swap's warm-up
    expect = 1 + 5 + 4 * event["candidates"] + event["swapped"]
    check(event["candidates"] == event["planned"] and got == expect,
          f"topo tune: {event} launches {got} != {expect}")
    gc.collect()
    torch.cuda.synchronize()
    mem0, calls0 = torch.cuda.memory_allocated(), instrument.launches()
    again = tuner.tune(rec["sm"], devices=eng.devices, block=eng.block,
                       hw=eng.hw, topology=topo)
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    emit({"phase": "topo_tune", "key": key.encode(), "event": event,
          "tune_s": tune_s, "winner": eng.registry.get("block").plan.tag,
          "winner_scheme_id": event["winner"], "serving_grid": list(grid),
          "second": {"from_cache": again.from_cache,
                     "measurements": len(again.measurements),
                     "launches": instrument.launches() - calls0,
                     "memory_delta_bytes": mem1 - mem0,
                     "scheme_id": again.best.scheme_id}})
    check(again.from_cache and not again.measurements
          and instrument.launches() == calls0 and mem1 == mem0,
          "topo tune: the second tune measured, launched or kept memory")
    del eng
    emit({"phase": "topology_launches", "launches": launches})
    return launches


# ------------------------------------------------------------- cluster

CLUSTER_NAMES = ("regular", "scale-free", "block")
ORACLE_OF = {"block-tuned": "block", "regular-ir": "regular"}  # phase 12 (c)
CLUSTER_MIX = {1: 0.6, 4: 0.25, 8: 0.15}  # the replays' widths and shares
POWER_STEPS = 20  # steps of each phase-12 session


def mem_free(torch) -> int:
    """Free bytes on the card, all processes' contexts counted."""
    return torch.cuda.mem_get_info()[0]


def worker_stats(router) -> dict:
    return {w: s for w, s in router.stats()["workers"].items() if not s.get("lost")}


def kernel_launches(stats: dict) -> int:
    """A worker's launches of the two kernels of the serving path."""
    return stats["launches"].get("coo", 0) + stats["launches"].get("bcoo", 0)


def registrations(stats: dict) -> int:
    return int(stats["metrics"].get("cluster.worker.registered", 0))


def check_worker_launches(before: dict, after: dict, what: str, steps=None) -> dict:
    """Each live worker launched one kernel per multiply it served, one per
    step of the sessions it ran (``steps[w]``: sessions, steps) and one per
    registration (its warm-up): the proof that the workers ran the kernels,
    not their plain versions."""
    out = {}
    for w, st in after.items():
        launched = kernel_launches(st) - kernel_launches(before[w])
        served = st["served"] - before[w]["served"]
        registered = registrations(st) - registrations(before[w])
        sessions = (steps or {}).get(w, (0, 0))
        want = served - sessions[0] + sessions[1] + registered
        out[w] = {"served": served, "launches": launched}
        check(launched == want,
              f"{what}: worker {w} launched {launched} kernels for {served} "
              f"served requests ({sessions[0]} sessions of {sessions[1]} steps) "
              f"and {registered} registrations")
    return out


def csr_oracle(sm):
    """The host oracle: the matrix as scipy CSR in float32."""
    import scipy.sparse as sp

    ri, ci, vals = (t.numpy() for t in sm.coalesced())
    rows, cols = sm.shape
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(ri, minlength=rows), out=indptr[1:])
    return sp.csr_matrix((vals.astype(np.float32), ci.astype(np.int32), indptr),
                         shape=(rows, cols))


def power_f64(a, x0, steps: int) -> np.ndarray:
    """float64 power iteration on the host (the sessions' oracle)."""
    a64, x = a.astype(np.float64), x0.astype(np.float64)
    for _ in range(steps):
        y = a64 @ x
        x = y / max(np.linalg.norm(y), 1e-30)
    return x


def cluster_register(torch, router, name, sm, drops, **kw) -> dict:
    """Register ``sm`` as int32-index triplets on one worker; print the
    frame's bytes, the router's wall s, the worker's register s and the
    card memory its placement took (all other processes idle)."""
    import pickle

    from repro_torch.cluster.protocol import HEADER, MAX_FRAME

    free0 = mem_free(torch)
    t0 = time.perf_counter()
    info = router.register(name, sm, replicas=1, **kw)
    wall_s = time.perf_counter() - t0
    drop = free0 - mem_free(torch)
    entry = router.entries[name]
    check(entry.triplets is not None and entry.triplets[0].dtype == np.int32
          and entry.triplets[1].dtype == np.int32,
          f"cluster {name}: not shipped as int32-index triplets")
    frame = HEADER.size + len(pickle.dumps(
        {"verb": "register", **entry.register_fields()},
        protocol=pickle.HIGHEST_PROTOCOL))
    check(frame <= MAX_FRAME, f"cluster {name}: frame {frame} B > {MAX_FRAME}")
    check(info["placements"] == entry.placements and len(entry.placements) == 1,
          f"cluster {name}: placements {info['placements']}")
    drops[info["placements"][0]] += drop
    emit({"phase": "cluster_register", "matrix": name, "source": info["source"],
          "scheme_id": info["scheme_id"], "impl": info["impl"],
          "nnz": len(entry.triplets[0]), "frame_mb": frame / 1e6,
          "router_wall_s": wall_s, "worker_register_s": info["register_s"],
          "placements": info["placements"], "card_bytes": drop})
    return info


def cluster_direct(router, oracles, rng, times) -> None:
    """(b) Per matrix 8 B=1, 2 B=4 and 2 B=8 multiplies through the router,
    each bit-equal to the scipy oracle; launches = served on every worker."""
    before = worker_stats(router)
    fmt = {"regular": "coo", "scale-free": "coo", "block": "bcoo"}
    for name in CLUSTER_NAMES:
        a = oracles[name]
        lat = {}
        for batch, count in ((1, 8), (4, 2), (8, 2)):
            for _ in range(count):
                shape = (a.shape[1],) if batch == 1 else (a.shape[1], batch)
                x = rng.integers(-2, 3, shape).astype(np.float32)
                t0 = time.perf_counter()
                y = router.multiply(name, x)
                lat.setdefault(batch, []).append(time.perf_counter() - t0)
                check(np.array_equal(y, (a @ x).astype(np.float32)),
                      f"cluster {name} B={batch}: answer != scipy oracle")
        t1, t8 = times[(name, fmt[name], 1)], times[(name, fmt[name], 8)]
        emit({"phase": "cluster_direct", "matrix": name,
              "router_ms_p50": {b: 1e3 * statistics.median(v) for b, v in lat.items()},
              "phase3_exe_ms_p50": t1["host_exe_ms_p50"],
              "phase4_kernel_ms": {1: t1["ms"], 8: t8["ms"]},
              "answers": "bit-equal to scipy"})
    got = check_worker_launches(before, worker_stats(router), "direct multiplies")
    emit({"phase": "cluster_direct_launches", "workers": got})


def cluster_plans(torch, router, sms, oracles, rng, device, tmp, drops) -> None:
    """(c) A tune record made in this process and a plan IR, shipped."""
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner, TuningCache

    tuner = Tuner(generator=CandidateGenerator(impls=("cuda",)), measurer=Measurer(),
                  cache=TuningCache(os.path.join(tmp, "tune.json")))
    t0 = time.perf_counter()
    result = tuner.tune(sms["block"], device=device)
    tune_s = time.perf_counter() - t0
    check(result.key.topology == "cuda:1" and not result.from_cache,
          f"cluster tune: key {result.key}, from_cache {result.from_cache}")
    record = {"entries": tuner.cache.export(result.key), "impls": ["cuda"],
              "batch": None, "block": [8, 16]}
    winner = result.best.scheme_id
    del result, tuner
    gc.collect()
    torch.cuda.empty_cache()
    info = cluster_register(torch, router, "block-tuned", sms["block"], drops,
                            tune_record=record)
    emit({"phase": "cluster_tune_record", "tune_s": tune_s, "winner": winner,
          "source": info["source"], "from_cache": info["from_cache"],
          "measurements": info["measurements"], "tune_hits": info["tune_hits"],
          "scheme_id": info["scheme_id"]})
    check(info["source"] == "tune_cache" and info["from_cache"] is True
          and info["measurements"] == 0 and info["tune_hits"] >= 1
          and info["scheme_id"] == winner,
          f"cluster tune record: {info} (parent's winner {winner})")
    ep = sms["regular"].plan(scheme="1d.nnz", fmt="csr", device=device)
    info = cluster_register(torch, router, "regular-ir", sms["regular"], drops,
                            ir=ep.to_ir())
    check(info["source"] == "ir" and info["scheme_id"] == ep.scheme_id,
          f"cluster IR: {info['source']} {info['scheme_id']} != {ep.scheme_id}")
    for name, oracle in (("block-tuned", "block"), ("regular-ir", "regular")):
        a = oracles[oracle]
        for batch in (1, 8):
            shape = (a.shape[1],) if batch == 1 else (a.shape[1], batch)
            x = rng.integers(-2, 3, shape).astype(np.float32)
            check(np.array_equal(router.multiply(name, x), (a @ x).astype(np.float32)),
                  f"cluster {name} B={batch}: answer != scipy oracle")


def cluster_sessions(router, oracles, rng) -> None:
    """(d) One 20-step power session per matrix through ``router.solve``."""
    before = worker_stats(router)
    steps = {}
    for name in CLUSTER_NAMES:
        a = oracles[name]
        x0 = rng.integers(-2, 3, a.shape[1]).astype(np.float32)
        requests = router.entries[name].requests
        t0 = time.perf_counter()
        res = router.solve(name, x0, steps=POWER_STEPS, combine="power")
        wall_s = time.perf_counter() - t0
        err = float(np.abs(res["x"] - power_f64(a, x0, POWER_STEPS)).max())
        check(res["steps"] == POWER_STEPS and err <= 1e-4,
              f"cluster session {name}: {res['steps']} steps, max err {err}")
        check(router.entries[name].requests == requests + POWER_STEPS,
              f"cluster session {name}: steps not charged to its placement")
        n, s = steps.get(res["worker_id"], (0, 0))
        steps[res["worker_id"]] = (n + 1, s + POWER_STEPS)
        emit({"phase": "cluster_session", "matrix": name, "steps": res["steps"],
              "worker": res["worker_id"], "max_abs_err": err, "wall_s": wall_s,
              "worker_s": res["seconds"]})
    got = check_worker_launches(before, worker_stats(router), "sessions", steps)
    emit({"phase": "cluster_session_launches", "workers": got})


def cluster_spec(seed: int, *salt):
    from repro_torch.serve import WorkloadSpec

    return WorkloadSpec(names=CLUSTER_NAMES, n_requests=120, seed=[seed, 12, *salt],
                        zipf_alpha=1.1, batch_mix=CLUSTER_MIX, integer_values=True)


def cluster_report_row(phase: str, report) -> dict:
    s = report.summary()
    return {"phase": phase, **{k: s[k] for k in (
        "requests", "accepted", "mismatched", "shed", "shed_reasons", "lost",
        "wall_s", "accepted_rps", "per_worker", "failovers", "latency")}}


def cluster_generators(router, oracles, seed: int) -> None:
    """(e) Two spawned load generators straight at the workers' sockets."""
    from repro_torch.cluster.replay import replay_generators
    from repro_torch.serve import generate_trace

    trace = generate_trace(cluster_spec(seed))
    before = worker_stats(router)
    report = replay_generators(router, trace, oracles, generators=2, timeout=300.0)
    got = check_worker_launches(before, worker_stats(router), "generator replay")
    emit({**cluster_report_row("cluster_generators", report), "workers": got})
    check(report.accepted + len(report.shed) == len(trace) and report.mismatched == 0
          and report.lost == 0,
          f"generator replay: {report.summary()}")


def cluster_chaos(torch, router, oracles, rng, seed: int, drops) -> None:
    """(f) A router-mode replay on 4 threads; w0 is killed after 40 answers."""
    import threading

    from repro_torch.cluster.replay import replay_cluster
    from repro_torch.serve import generate_trace

    victim, survivor = "w0", "w1"
    trace = generate_trace(cluster_spec(seed, 1))
    samples, stop, kill = [], threading.Event(), {}

    def monitor():  # the card's free bytes every 20 ms
        while not stop.is_set():
            samples.append((time.perf_counter(), mem_free(torch)))
            stop.wait(0.02)

    def kill_worker(wid):
        with router._lock:
            kill["exclusive"] = sorted(n for n, e in router.entries.items()
                                       if e.placements == [wid])
        kill["free"], kill["t"] = mem_free(torch), time.perf_counter()
        type(router).kill_worker(router, wid)

    router.kill_worker = kill_worker
    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    try:
        report = replay_cluster(router, trace, oracles, threads=4, kill_after=40,
                                kill_worker=victim)
    finally:
        stop.set()
        mon.join(timeout=5)
        del router.kill_worker
    window = [f for t, f in samples if kill["t"] <= t <= kill["t"] + 10]
    rise = max(window, default=kill["free"]) - kill["free"]
    event = next(f for f in router.failovers if f["worker_id"] == victim)
    emit({**cluster_report_row("cluster_chaos", report),
          "exclusive": kill["exclusive"], "rehomed": event["rehomed"],
          "failover_stall_ms": 1e3 * max(report.latencies_s),
          "victim_card_bytes": drops[victim], "freed_within_10s_bytes": rise})
    check(report.lost == 0 and report.mismatched == 0
          and {s["reason"] for s in report.shed} <= {"worker_lost"},
          f"chaos replay: {report.summary()}")
    check(report.failovers >= 1 and sorted(event["rehomed"]) == kill["exclusive"]
          and kill["exclusive"], f"chaos replay: rehomed {event}, "
          f"{victim} held {kill['exclusive']} alone")
    check(router.workers[survivor].alive() and not router.workers[victim].alive(),
          "chaos replay: the wrong worker died")
    check(rise >= drops[victim] / 2,
          f"chaos replay: {rise} B freed within 10 s of the kill < half of "
          f"the {drops[victim]} B {victim} took")
    for name, entry in router.entries.items():
        a = oracles[ORACLE_OF.get(name, name)]
        x = rng.integers(-2, 3, a.shape[1]).astype(np.float32)
        check(entry.placements == [survivor]
              and np.array_equal(router.multiply(name, x), (a @ x).astype(np.float32)),
              f"after the kill {name} on {entry.placements}: answer != scipy oracle")


def phase_cluster(torch, rng, device, n: int, seed: int, times) -> dict:
    """Phase 12: the multi-process cluster at full width (see the module
    docstring; the block matrix is n/2 square); returns the workers'
    kernel launches before the kill."""
    import shutil
    import tempfile

    from repro_torch.api import SparseMatrix
    from repro_torch.cluster import ClusterRouter
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.build_all()  # built in phase 1: the workers only load them
    makers = {"regular": lambda: regular_triplets(rng, n),
              "scale-free": lambda: scale_free_triplets(rng, n, 8 * n),
              "block": lambda: block_triplets(rng, n // 2)}
    sms, oracles = {}, {}
    t0 = time.perf_counter()
    for name, make in makers.items():
        ri, ci, vals, shape = make()
        sms[name] = SparseMatrix.from_parts(ri, ci, vals, shape)
        oracles[name] = csr_oracle(sms[name])
    setup_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-cluster-")
    free0 = mem_free(torch)
    t0 = time.perf_counter()
    # replication off: each matrix stays on its ring owner, so the kill in
    # (f) re-homes what w0 alone held (tests/test_torch_cluster.py holds
    # popularity replication)
    router = ClusterRouter(workers=2, socket_dir=tmp, connect_timeout=300,
                           replicate_share=1.0)
    try:
        spawn_s = time.perf_counter() - t0
        free1 = mem_free(torch)
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        emit({"phase": "cluster_fleet", "workers": 2, "spawn_s": spawn_s,
              "setup_s": setup_s, "compute_mode": mode, "free_before_bytes": free0,
              "free_after_spawn_bytes": free1})
        drops = {w: (free0 - free1) // 2 for w in router.workers}  # start-up
        for name in CLUSTER_NAMES:
            cluster_register(torch, router, name, sms[name], drops)
        cluster_direct(router, oracles, rng, times)
        cluster_plans(torch, router, sms, oracles, rng, device, tmp, drops)
        del sms
        cluster_sessions(router, oracles, rng)
        cluster_generators(router, oracles, seed)
        launches = {k: 0 for k in ("coo", "bcoo")}
        for st in worker_stats(router).values():
            for k in launches:
                launches[k] += st["launches"].get(k, 0)
        check(all(launches.values()), f"cluster: a kernel never launched: {launches}")
        cluster_chaos(torch, router, oracles, rng, seed, drops)
    finally:
        router.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cluster_done", "seconds": time.perf_counter() - t_phase,
          "launches": launches, "free_after_close_bytes": mem_free(torch),
          "free_before_bytes": free0})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build, instrument  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found beside this script: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the oracles
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for line in ptxas_lines(_build):
        print(line)
    hmma = sass_mma_counts(_build, "bcoo_spmv")
    emit({"phase": "sass", "kernel": "bcoo_spmv", "hmma": hmma})
    if "cuobjdump" not in hmma:  # both f32 tensor-core kernels issue mma
        for kern in ("bcoo_mma_kernel<f,", "bcoo_mma_reg_kernel<f,"):
            check(any(n.startswith(kern) for n in hmma),
                  f"no HMMA in {kern}...>: {hmma}")
    emit({"phase": "build", "seconds": build_s, "kernels": list(_build.SOURCES)})

    errs = {k: 0.0 for k in KERNELS}
    phase_kernels(torch, rng, device, 1 << 16, errs,
                  np.random.default_rng([args.seed, 64]))
    records = []
    launches, requests = phase_main_path(
        torch, rng, device, (1 << 21, 1 << 21, 1 << 20), errs, records)
    check(launches == requests, f"launch counters {launches} != requests {requests}")
    times = phase_times(torch, rng, device, records)
    phase_pieces(torch, rng, device, records)
    phase_ell_kernel(torch, rng, device, 1 << 16, errs)
    ell_launches, ell_times = phase_ell_path(torch, rng, device, records, errs)
    part_launches, part_rows, autos = phase_partitioned(torch, rng, device,
                                                        records, 1 << 16)
    rng10 = np.random.default_rng([args.seed, 10])  # phases 1-9 draw as before
    t10 = time.perf_counter()
    solver_launches = phase_solver(torch, rng10, device, records, autos, times)
    solver_s = time.perf_counter() - t10
    t13 = time.perf_counter()
    topo_launches = phase_topology(torch, np.random.default_rng([args.seed, 13]),
                                   device, records, autos)
    topology_s = time.perf_counter() - t13
    del autos
    gc.collect()
    serve_launches_, eng = phase_serving(torch, rng, device, records, args.seed)
    t10 = time.perf_counter()
    solver_serve = phase_solver_service(torch, rng10, device, eng, records)
    solver_s += time.perf_counter() - t10
    del eng
    gc.collect()
    t11 = time.perf_counter()
    tune_launches = phase_tuning(torch, np.random.default_rng([args.seed, 11]),
                                 device, records)
    tuning_s = time.perf_counter() - t11
    records.clear()  # free the main path's plans for the dense oracles
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory", "allocated_bytes": torch.cuda.memory_allocated()})
    oracle_launches, solver_replay_ = phase_serving_oracle(
        torch, rng, device, 1 << 16, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    cluster_launches = phase_cluster(torch, np.random.default_rng([args.seed, 12]),
                                     device, 1 << 21, args.seed, times)
    cluster_s = time.perf_counter() - t12

    by_path = {
        kernel: {"single_device": launches[kind],
                 "partitioned": part_launches[kind],
                 "serving": serve_launches_[kind] + oracle_launches[kind],
                 "solver": (solver_launches[kind] + solver_serve[kind]
                            + solver_replay_[kind]),
                 "tuning": tune_launches[kind],
                 "cluster": cluster_launches[kind],
                 "topology": topo_launches[kind]}
        for kernel, kind in (("coo_spmv", "coo"), ("bcoo_spmv", "bcoo"))
    }
    by_path["ell_spmv"] = {"ell": ell_launches}
    main_shape = {"coo_spmv": ("regular", "coo", 1), "bcoo_spmv": ("block", "bcoo", 1)}
    times["ell_spmv"] = ell_times["regular"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[main_shape.get(name, name)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "also_replaces": ALSO_REPLACES.get(name, []),
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "solver_phase_s": solver_s, "tuning_phase_s": tuning_s,
          "cluster_phase_s": cluster_s, "topology_phase_s": topology_s,
          "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
