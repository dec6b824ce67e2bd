"""A/B of builds of the port's CUDA kernels (COO, ELL and block), in one
process on one card, at chip_smoke.py's full-size matrices.

    python tools/kernel_ab.py [--cases=PREFIX,...] VARIANT [VARIANT ...]

A VARIANT is a directory holding coo_spmv.cu / bcoo_spmv.cu / ell_spmv.cu /
common.cuh ("src" is the checkout's own sources), optionally followed by
":NAME=VALUE,..." to replace those ``constexpr`` constants in a copy (for
example ``src:kMmaWarps=4``).  Each variant is built with the port's nvcc
flags into build/ab/, checked bit for bit against the plain versions on
integer-valued inputs, and timed with CUDA events in turns (a, b, ..., b,
a).  ``--cases`` keeps the cases whose label starts with one of the
prefixes (for example ``--cases=bcoo``).  The block cases are the block
matrix at B = 1, 8 and 64, B = 8 on each route that takes it, and the
16-part (8, 2) launch.  It prints one JSON line per case.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.coo_spmv import coo_spmv, coo_spmv_plain, plan_chunks  # noqa: E402
from repro_torch.kernels.ell_spmv import _pack_ell, ell_spmv, ell_spmv_plain  # noqa: E402

AB_DIR = os.path.join(ROOT, "build", "ab")


def emit(obj):
    print(json.dumps(obj), flush=True)


def sources(v):
    """A variant's source directory: "dir" or "dir:NAME=VALUE,..." (a copy
    of dir with those constexpr constants replaced)."""
    import re
    base, _, knobs = v.partition(":")
    src = str(_build.CSRC) if base == "src" else os.path.join(ROOT, base)
    dst = os.path.join(AB_DIR, re.sub(r"\W+", "_", v))
    os.makedirs(dst, exist_ok=True)
    for f in ("coo_spmv.cu", "bcoo_spmv.cu", "ell_spmv.cu", "common.cuh"):
        text = open(os.path.join(src, f)).read()
        for kv in filter(None, knobs.split(",")):
            name, val = kv.split("=")
            text = re.sub(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{val};", text)
        open(os.path.join(dst, f), "w").write(text)
    return dst


def build(variants, names):
    nvcc = _build._nvcc()
    procs, libs = {}, {}
    for v in variants:
        src = sources(v)
        for name in names:
            out = os.path.join(src, f"{name}.so")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", out, os.path.join(src, name + ".cu")]
            procs[(v, name)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    for (v, name), (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{v} {name}: {log[-4000:]}")
        emit({"ptxas": v, "kernel": name,
              "regs": {e: u.split(",")[0] + (" SPILLS" if "0 bytes spill stores" not in sp
                                              else "")
                       for e, u, sp in cs.ptxas_summary(log)}})
        fn = getattr(ctypes.CDLL(out), _build.SOURCES[name][1])
        fn.argtypes = _build.SOURCES[name][2]
        fn.restype = ctypes.c_int
        libs[(v, name)] = fn
    return libs


def block_cases(rng, dev):
    """(label, kernel, run, plain) of the block kernel: the block matrix of
    chip_smoke.py at B = 1, 8 and 64, B = 8 on every route that takes it,
    and its 16-part auto plan's part-axis launch."""
    from repro_torch.api import SparseMatrix
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmv import ROUTES, bcoo_spmv_cuda, route_takes

    ri, ci, vals, shape = cs.block_triplets(rng, 1 << 20)
    sm = SparseMatrix.from_parts(ri, ci, vals, shape)
    prog = ops.kernel_program(sm.container("bcoo", block=(8, 16)), device=dev)
    cases = []
    for B in (1, 8, 64):
        xs = (shape[1],) if B == 1 else (shape[1], B)
        x = torch.from_numpy(rng.integers(-2, 3, xs).astype(np.float32)).to(dev)
        cases.append((f"bcoo block B={B}", "bcoo_spmv", lambda x=x: prog(x),
                      lambda x=x: prog.plain(x)))
        if B == 8:
            for route in ROUTES:
                if route_takes(route, torch.float32, 8, 16, B):
                    cases.append((f"bcoo block B=8 route={route}", "bcoo_spmv",
                                  lambda x=x, rt=route: bcoo_spmv_cuda(
                                      prog.browptr, prog.bcolind, prog.bvalues, x,
                                      prog.rows, route=rt),
                                  lambda x=x: prog.plain(x)))
    exe = sm.plan(scheme="auto", devices=[dev] * 16).compile()
    local, arrs = exe.program.local, D._flat(exe.arrays)
    xb = exe.program.x_buffer(exe.place(rng.integers(-2, 3, shape[1]).astype(np.float32)))
    cases.append((f"bcoo part {exe.plan.scheme_id} {list(exe.plan.grid)}", "bcoo_spmv",
                  lambda: local.raw(arrs, xb), lambda: local.plain(arrs, xb)))
    return cases


def scalar_cases(rng, dev):
    """(label, kernel, run, plain) of the COO and ELL kernels."""
    n = 1 << 21
    cases = []
    for name, make in (("regular", lambda: cs.regular_triplets(rng, n)),
                       ("scale-free", lambda: cs.scale_free_triplets(rng, n, 8 * n))):
        ri, ci, vals, shape = make()
        ri, ci, v = F.coalesce(ri, ci, F.to_tensor(vals), shape)
        plan = plan_chunks(ri, ci, v, shape[0]).to(dev)
        for B in (1, 8, 64):
            xs = (shape[1],) if B == 1 else (shape[1], B)
            x = torch.from_numpy(rng.integers(-2, 3, xs).astype(np.float32)).to(dev)
            cases.append((f"coo {name} B={B}", "coo_spmv",
                          lambda plan=plan, x=x: coo_spmv(plan, x),
                          lambda plan=plan, x=x: coo_spmv_plain(plan, x)))
        if name == "regular":
            arrs = [t.to(dev) for t in _pack_ell(ri, ci, v, shape[0], 16)]
            x = torch.from_numpy(rng.integers(-2, 3, shape[1]).astype(np.float32)).to(dev)
            cases.append(("ell regular K=16", "ell_spmv",
                          lambda a=arrs, x=x: ell_spmv(*a, x),
                          lambda a=arrs, x=x: ell_spmv_plain(*a, x)))
    from repro_torch.api import SparseMatrix
    from repro_torch.core import distributed as D
    ri, ci, vals, shape = cs.regular_triplets(rng, n)
    exe = SparseMatrix.from_parts(ri, ci, vals, shape).plan(
        scheme="2d.equally-wide", devices=[dev] * 16).compile()
    local, arrs16 = exe.program.local, D._flat(exe.arrays)
    xb = exe.program.x_buffer(exe.place(rng.integers(-2, 3, shape[1]).astype(np.float32)))
    cases.append(("coo part 2d.equally-wide", "coo_spmv",
                  lambda: local.raw(arrs16, xb), lambda: local.plain(arrs16, xb)))
    ri, ci, vals, shape = cs.block_triplets(rng, 1 << 20)
    ri, ci, v = F.coalesce(ri, ci, F.to_tensor(vals), shape)
    arrs = [t.to(dev) for t in _pack_ell(ri, ci, v, shape[0], 48)]
    x = torch.from_numpy(rng.integers(-2, 3, shape[1]).astype(np.float32)).to(dev)
    cases.append(("ell block K=48", "ell_spmv", lambda a=arrs, x=x: ell_spmv(*a, x),
                  lambda a=arrs, x=x: ell_spmv_plain(*a, x)))
    return cases


def main():
    argv = sys.argv[1:]
    only = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--cases=")]
    only = only[0] if only else None
    variants = [a for a in argv if not a.startswith("--")] or ["src"]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    wanted = lambda *ks: only is None or any(  # noqa: E731
        p.startswith(k) or k.startswith(p) for p in only for k in ks)
    cases = block_cases(rng, dev) if wanted("bcoo") else []
    if wanted("coo", "ell"):
        cases += scalar_cases(rng, dev)
    if only is not None:
        cases = [cs_ for cs_ in cases if any(cs_[0].startswith(p) for p in only)]
    t0 = time.perf_counter()
    libs = build(variants, sorted({kernel for _, kernel, _, _ in cases}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"built": variants, "s": time.perf_counter() - t0,
          "card": smi.stdout.strip()})
    order = variants + variants[::-1]
    for label, kernel, run, plain in cases:
        want = plain()
        times = {v: [] for v in variants}
        for v in order:
            _build._LIBS[kernel] = libs[(v, kernel)]
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} {v}: != plain")
            times[v].append(cs.time_ms(torch, run, 30))
        emit({"case": label, **{v: times[v] for v in variants}})


if __name__ == "__main__":
    main()
