"""Subprocess body of tests/test_torch_mesh.py: the JAX package's side.

It needs 4 fake devices, so it owns its process (XLA_FLAGS is set before
jax imports).  For every case of tests/_torch_mesh_cases.py it builds the
JAX ``MeshExecutor`` and stores, in the .npz file named on the command
line, the three phases' outputs (``place`` / ``run_raw`` / ``assemble``),
``exe.batch(X)`` and the scheme id; plus the plan IRs of IR_PLANS in both
directions.  bfloat16 arrays are stored widened to float32 (exact), and the
dtype the executor returned is stored beside ``assemble`` / ``batch``.
For every solver case (SOLVER_CASES) it stores ``exe.iterate``'s x, step
count and convergence flag.  Prints ``DEVICES <n>`` first and ``MESH SKIP`` when forcing devices failed.

    python tests/_torch_mesh_runner.py OUT.npz [CASE_ID ...]

Given case ids, it runs only those cases and no plan IRs.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.api import SparseMatrix, plan_from_ir, plan_from_partitioned  # noqa: E402
from repro.core import distributed as D  # noqa: E402
from repro.core.partition import partition_1d  # noqa: E402

from _torch_mesh_cases import (BLOCK, DRYRUN_SPMV, DRYRUN_SYNTH,  # noqa: E402
                               IR_PLANS, PARTS, SOLVER_CASES, cases, dryrun_x,
                               matrix, solver_inputs, vectors)

BF16 = np.dtype(jnp.bfloat16)


def host(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == BF16 else a


def inputs(dtype):
    a = matrix(dtype)
    x, X = vectors(dtype)
    if dtype == "bf16":
        a, x, X = a.astype(BF16), x.astype(BF16), X.astype(BF16)
    return a, x, X


def main(out_path: str, only=()) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < PARTS:
        print("MESH SKIP")
        return
    devices = jax.devices()[:PARTS]
    res = {}
    for case_id, plan, dtype, (_, impl) in cases():
        if only and case_id not in only:
            continue
        _, scheme, fmt, merge, grid, ring = plan
        a, x, X = inputs(dtype)
        sm = SparseMatrix.from_dense(a)
        if ring:
            part = partition_1d(a, PARTS, fmt=fmt, balance=scheme.split(".")[1],
                                block=BLOCK)
            part_r, counts = D.bucket_by_source_shard(part, PARTS)
            mesh = compat.make_mesh((PARTS,), ("parts",), devices=devices)
            pln = plan_from_partitioned(part_r, mesh, impl=impl, ring=True,
                                        ring_counts=counts, matrix=sm)
        else:
            pln = sm.plan(scheme=scheme, fmt=fmt, merge=merge, grid=grid,
                          impl=impl, devices=devices, block=BLOCK)
        exe = pln.compile()
        xs = exe.place(x)
        raw = exe.run_raw(xs)
        res[f"{case_id}|scheme_id"] = np.array(pln.scheme_id)
        res[f"{case_id}|place"] = host(xs)
        res[f"{case_id}|raw"] = host(raw)
        y, Y = np.asarray(exe.assemble(raw)), np.asarray(exe.batch(X))
        res[f"{case_id}|y"], res[f"{case_id}|Y"] = host(y), host(Y)
        res[f"{case_id}|y_dtype"] = np.array(y.dtype.name)
        res[f"{case_id}|Y_dtype"] = np.array(Y.dtype.name)
    for case_id, scheme, fmt, combine, (_, impl) in SOLVER_CASES:
        if only and case_id not in only:
            continue
        a, x0, kw = solver_inputs(combine)
        pln = SparseMatrix.from_dense(a).plan(scheme=scheme, fmt=fmt, impl=impl,
                                              devices=devices, block=BLOCK)
        out = pln.compile().iterate(x0, **kw)
        res[f"{case_id}|scheme_id"] = np.array(pln.scheme_id)
        res[f"{case_id}|x"] = np.asarray(out.x)
        res[f"{case_id}|steps"] = np.array(out.steps)
        res[f"{case_id}|converged"] = np.array(out.converged)
    if not only or "dryrun" in only:
        dryrun(res, devices)
    if only:
        np.savez(out_path, **res)
        print("MESH DONE")
        return

    # plan IRs, both ways
    import repro_torch.api as T

    for name, scheme, fmt, timpl in IR_PLANS:
        a, x, _ = inputs("f32")
        jsm, tsm = SparseMatrix.from_dense(a), T.SparseMatrix.from_dense(a)
        jimpl = {"torch": "xla", "cuda": "pallas"}[timpl]
        jir = jsm.plan(scheme=scheme, fmt=fmt, impl=jimpl, devices=devices,
                       block=BLOCK).to_ir()
        res[f"{name}|jax_ir"] = np.array(json.dumps(jir))
        res[f"{name}|jax_y"] = host(plan_from_ir(jir, jsm, devices=devices)
                                    .compile()(x))
        tir = json.loads(json.dumps(tsm.plan(
            scheme=scheme, fmt=fmt, impl=timpl, devices=["cpu"] * PARTS,
            block=BLOCK).to_ir()))
        jp = plan_from_ir(tir, jsm, devices=devices)
        res[f"{name}|port_ir"] = np.array(json.dumps(tir))
        res[f"{name}|port_ir_scheme_id"] = np.array(jp.scheme_id)
        res[f"{name}|port_ir_y"] = host(jp.compile()(x))
    np.savez(out_path, **res)
    print("MESH DONE")


def dryrun(res: dict, devices) -> None:
    """Case "dryrun": the dry run's optimizer settings and microbatches of
    every arch and shape, synth_partition_1d's arrays, and the SpMV dry
    run's 1D and ring programs (the ring bucketed first) on PARTS parts."""
    import dataclasses

    from repro.configs import get_config, list_configs
    from repro.configs.base import SHAPES
    from repro.launch import dryrun as DR  # jax is up: its XLA_FLAGS is moot
    from repro.launch import dryrun_spmv as DS

    res["dryrun|settings"] = np.array(json.dumps({
        a: {"opt": dataclasses.asdict(DR._opt_cfg(get_config(a))),
            "microbatches": {s: DR._microbatches(get_config(a), s)
                             for s in SHAPES}}
        for a in list_configs()}))
    syn = DS.synth_partition_1d(DRYRUN_SYNTH["rows"], DRYRUN_SYNTH["cols"],
                                DRYRUN_SYNTH["nnz_per_row"], DRYRUN_SYNTH["parts"])
    for f in ("rowind", "colind", "values", "nnz", "row_start", "col_start",
              "row_extent", "col_extent"):
        res[f"dryrun|synth|{f}"] = np.asarray(getattr(syn, f))
    mat = DS.synth_partition_1d(DRYRUN_SPMV["rows"], DRYRUN_SPMV["cols"],
                                DRYRUN_SPMV["nnz_per_row"], PARTS)
    mesh = compat.make_mesh((PARTS,), ("parts",), devices=devices)
    part_r, counts = D.bucket_by_source_shard(mat, PARTS)
    x, X = dryrun_x()
    for name, pln in (("1d", plan_from_partitioned(mat, mesh)),
                      ("ring", plan_from_partitioned(part_r, mesh, ring=True,
                                                     ring_counts=counts))):
        exe = pln.compile()
        res[f"dryrun|{name}|y"] = np.asarray(exe(x))
        res[f"dryrun|{name}|Y"] = np.asarray(exe.batch(X))


if __name__ == "__main__":
    main(sys.argv[1], tuple(sys.argv[2:]))
