"""Rank bodies of the port's process-mesh tests (numpy and torch only).

``tests/test_torch_mesh.py`` and ``tests/test_torch_collectives.py`` start
one gloo world of 4 CPU ranks per module (``repro_torch.core.world.spawn``)
and run a function of this module on every rank.  The ranks build the same
inputs from the same seeds (``tests/_torch_mesh_cases.py``), each places
only its own part of a process mesh, and each returns what it saw as numpy
arrays (bfloat16 widened to float32, exact); the tests compare them with
the JAX package's runner (``tests/_torch_mesh_runner.py``) part by part.
"""
import json

import ml_dtypes
import numpy as np
import torch

from repro_torch.api import SparseMatrix, plan_from_ir, plan_from_partitioned
from repro_torch.core import distributed as D
from repro_torch.core import sharding as SH
from repro_torch.core.collectives import Collectives
from repro_torch.core.sharding import P
from repro_torch.core.mesh import AXES_2D, AXIS_1D, make_process_mesh
from repro_torch.core.partition import partition_1d
from repro_torch.kernels import instrument

import _solver_runner as sr
from _torch_mesh_cases import (BLOCK, IR_PLANS, PARTS, SOLVER_CASES, cases,
                               matrix, solver_inputs, vectors)

BF16 = np.dtype(ml_dtypes.bfloat16)
CPU4 = ["cpu"] * PARTS


def host(a) -> np.ndarray:
    """A result as numpy, bfloat16 (tensor or ml_dtypes) widened to f32."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == BF16 else a


def inputs(dtype):
    a = matrix(dtype)
    x, X = vectors(dtype)
    if dtype == "bf16":
        a, x, X = a.astype(BF16), x.astype(BF16), X.astype(BF16)
    return a, x, X


class Meshes:
    """This rank's process meshes, one per grid (built collectively, once).
    Made first in every rank body: it also keeps the rank to one thread,
    so the ranks' tiny ops do not fight over the cores."""

    def __init__(self, world):
        torch.set_num_threads(1)
        self.world, self.by_shape = world, {}

    def __call__(self, shape):
        shape = tuple(shape)
        if shape not in self.by_shape:
            names = (AXIS_1D,) if len(shape) == 1 else AXES_2D
            self.by_shape[shape] = make_process_mesh(self.world, shape, names)
        return self.by_shape[shape]


def _plan(meshes, plan, impl, sm, a):
    _, scheme, fmt, merge, grid, ring = plan
    if ring:
        part = partition_1d(a, PARTS, fmt=fmt, balance=scheme.split(".")[1],
                            block=BLOCK)
        part_r, counts = D.bucket_by_source_shard(part, PARTS)
        return plan_from_partitioned(part_r, meshes((PARTS,)), impl=impl,
                                     ring=True, ring_counts=counts, matrix=sm)
    # the grid the fitted plan takes, then its process mesh
    fitted = sm.plan(scheme=scheme, fmt=fmt, merge=merge, grid=grid,
                     impl=impl, devices=CPU4, block=BLOCK)
    shape = fitted.grid[:1] if fitted.partitioning == "1d" else fitted.grid
    return sm.plan(scheme=scheme, fmt=fmt, merge=merge, grid=grid, impl=impl,
                   mesh=meshes(shape), block=BLOCK)


def mesh_cases(world) -> dict:
    """Every case, solver case and plan IR of tests/_torch_mesh_cases.py
    on this rank; keys as the JAX runner's."""
    meshes, res = Meshes(world), {}
    for case_id, plan, dtype, (impl, _) in cases():
        a, x, X = inputs(dtype)
        sm = SparseMatrix.from_dense(a)
        pln = _plan(meshes, plan, impl, sm, a)
        instrument.reset()
        exe = pln.compile()
        xs = exe.place(x)
        raw = exe.run_raw(xs)
        y = exe.assemble(raw)
        Y = exe.batch(X)
        res[f"{case_id}|scheme_id"] = pln.scheme_id
        res[f"{case_id}|device"] = str(pln.device)
        res[f"{case_id}|mesh"] = (tuple(pln.mesh.devices.shape), pln.mesh.coords)
        res[f"{case_id}|place"] = host(xs)
        res[f"{case_id}|raw"] = host(raw.y_parts)
        res[f"{case_id}|y"], res[f"{case_id}|Y"] = host(y), host(Y)
        res[f"{case_id}|dtypes"] = (y.dtype.name, Y.dtype.name)
        res[f"{case_id}|call_is_phases"] = bool(np.array_equal(exe(x), y))
        res[f"{case_id}|launches"] = instrument.launches()
    for case_id, scheme, fmt, combine, (impl, _) in SOLVER_CASES:
        a, x0, kw = solver_inputs(combine)
        pln = SparseMatrix.from_dense(a).plan(scheme=scheme, fmt=fmt, impl=impl,
                                              devices=CPU4, block=BLOCK)
        shape = pln.grid[:1] if pln.partitioning == "1d" else pln.grid
        pln = SparseMatrix.from_dense(a).plan(scheme=scheme, fmt=fmt, impl=impl,
                                              mesh=meshes(shape), block=BLOCK)
        exe = pln.compile()
        out = exe.iterate(x0, **kw)
        res[f"{case_id}|scheme_id"] = pln.scheme_id
        res[f"{case_id}|x"] = np.asarray(out.x)
        res[f"{case_id}|steps"] = out.steps
        res[f"{case_id}|converged"] = out.converged
        if combine != "power-tol":
            res[f"{case_id}|host_loop"] = sr.host_loop(
                exe, x0, kw["steps"], combine, b=kw.get("b"),
                diag=kw.get("diag"), omega=kw.get("omega", 1.0))
    for name, scheme, fmt, impl in IR_PLANS:
        a, x, _ = inputs("f32")
        sm = SparseMatrix.from_dense(a)
        fitted = sm.plan(scheme=scheme, fmt=fmt, impl=impl, devices=CPU4,
                         block=BLOCK)
        shape = fitted.grid[:1] if fitted.partitioning == "1d" else fitted.grid
        ir = json.loads(json.dumps(sm.plan(scheme=scheme, fmt=fmt, impl=impl,
                                           mesh=meshes(shape),
                                           block=BLOCK).to_ir()))
        res[f"{name}|ir"] = ir
        back = plan_from_ir(ir, sm, mesh=meshes(shape))
        res[f"{name}|scheme_id"] = back.scheme_id
        res[f"{name}|y"] = host(back.compile()(x))
    return res


def collective_cases(world) -> dict:
    """The collectives' semantics and counts on this rank (see
    tests/test_torch_collectives.py)."""
    meshes, res = Meshes(world), {}
    r = world.rank
    m1 = meshes((PARTS,))
    c1 = Collectives(m1)
    x = torch.full((3,), float(r + 1))
    res["boundary"] = c1.ppermute(x, AXIS_1D, [(i, i - 1) for i in range(1, PARTS)])
    res["ring"] = c1.ppermute(x, AXIS_1D, [(i, (i - 1) % PARTS)
                                          for i in range(PARTS)])
    res["self"] = c1.ppermute(x, AXIS_1D, [(i, i) for i in range(PARTS)])
    res["gather_1d"] = c1.all_gather(torch.arange(2) + 10 * r, AXIS_1D)
    res["counts_1d"] = c1.snapshot()
    m2 = meshes((2, 2))
    c2 = Collectives(m2)
    res["coords"] = m2.coords
    v = torch.arange(4) + 100 * r
    res["gather_rows"] = c2.all_gather(v[:2], AXES_2D[0])
    res["gather_cols"] = c2.all_gather(v[:2], AXES_2D[1])
    res["gather_all"] = c2.all_gather(v[:1], AXES_2D)
    res["scatter_cols"] = c2.psum_scatter(v.float(), AXES_2D[1])
    res["psum_cols"] = c2.psum(v.float(), AXES_2D[1])
    res["psum_all"] = c2.psum(v.float(), AXES_2D)
    res["psum_i8"] = c2.psum(torch.full((2,), 100, dtype=torch.int8), AXES_2D)
    res["psum_bf16"] = c2.psum(torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
                               + r, AXES_2D)
    res["counts_2d"] = c2.snapshot()
    # the mesh's own collectives: its ranks share this host, so the data
    # moves through shared memory
    res["mesh_transport"] = (m2.one_host, SH.collectives(m2).transport)
    # the same calls with the data through shared memory, in 24-byte
    # rounds (every message but the scalars takes several)
    from repro_torch.core.collectives import SharedMemoryCollectives

    shm = SharedMemoryCollectives(m2, slot=24)
    res["shm"] = {
        "gather_rows": shm.all_gather(v[:2], AXES_2D[0]),
        "gather_all": shm.all_gather(v[:1], AXES_2D),
        "scatter_cols": shm.psum_scatter(v.float(), AXES_2D[1]),
        "psum_all": shm.psum(v.float(), AXES_2D),
        "psum_i8": shm.psum(torch.full((2,), 100, dtype=torch.int8), AXES_2D),
        "psum_bf16": shm.psum(torch.tensor([1.0, 2.0], dtype=torch.bfloat16) + r,
                              AXES_2D),
        "big": shm.psum(torch.arange(50.0) * (r + 1), AXES_2D[1]),
        "a2a": shm.all_to_all((10 * r + torch.arange(4.0))[:, None].expand(4, 2)
                              .contiguous(), AXES_2D[1], split_dim=0, concat_dim=1),
        "transport": shm.transport, "counts": shm.snapshot()}
    # all-to-all over "cols": x (4, 2), value 10 * rank + row
    c2.reset()
    xa = (10 * r + torch.arange(4.0))[:, None].expand(4, 2).contiguous()
    res["a2a_cols"] = c2.all_to_all(xa, AXES_2D[1], split_dim=0, concat_dim=1)
    res["a2a_rows_first"] = c2.all_to_all(xa, AXES_2D[1], split_dim=0,
                                          concat_dim=0)
    res["counts_a2a"] = c2.snapshot()
    # reshard between specs of a (4, 4) tensor, value 4 * row + col
    full = torch.arange(16.0).reshape(4, 4)
    coll = SH.collectives(m2)
    coll.reset()
    with SH.set_mesh(m2):
        rows = SH.reshard(full, P(), P(AXES_2D[0]))
        res["rs_slice"] = rows
        cols = SH.reshard(rows, P(AXES_2D[0]), P(None, AXES_2D[0]))
        res["rs_a2a"] = cols
        res["rs_gather"] = SH.reshard(cols, P(None, AXES_2D[0]), P())
        # partial over "rows": every rank holds the full tensor's
        # "cols" block; the psum over the 2 ranks of "rows" doubles it
        part = SH.reshard(full, P(), P(None, AXES_2D[1]))
        res["rs_psum"] = SH.reshard(part, P(None, AXES_2D[1]),
                                    P(None, AXES_2D[1]), partial=AXES_2D[0])
        counts = coll.snapshot()
        # common.shard: the reference's constraint rules (an entry whose
        # extent does not divide the dim is dropped), from replicated
        from repro_torch.models.common import shard

        res["shard_rows"] = shard(full, AXES_2D[0], None)
        res["shard_odd"] = shard(torch.arange(12.0).reshape(3, 4), AXES_2D[0], "nope")
    res["counts_rs"] = counts
    # one SpMV of each merge on the 4-rank meshes, with its counts
    a, x, X = inputs("f32")
    sm = SparseMatrix.from_dense(a)
    for name, scheme, fmt, merge in (
            ("1d-nnz", "1d.nnz", "coo", None),
            ("2d-psum", "2d.equally-sized", "coo", "psum"),
            ("2d-scatter", "2d.equally-sized", "coo", "psum_scatter"),
            ("2d-global", "2d.equally-sized", "coo", "global"),
            ("2d-vs", "2d.variable-sized", "coo", None)):
        exe = _plan(meshes, (name, scheme, fmt, merge, None, False), "torch",
                    sm, a).compile()
        raw = exe.run_raw(exe.place(x))
        load_merge = exe.collectives.snapshot()
        exe.assemble(raw)
        res[f"spmv|{name}"] = dict(run_raw=load_merge,
                                   call=exe.collectives.snapshot(),
                                   part=exe.part, rank_part=exe.arrays["nnz"])
    ring = _plan(meshes, ("ring", "1d.nnz", "coo", None, None, True), "torch",
                 sm, a).compile()
    ring.run_raw(ring.place(x))
    res["spmv|ring"] = dict(run_raw=ring.collectives.snapshot(), part=ring.part,
                            rank_part=ring.arrays["nnz"])
    return res


def fails_on_rank_1(world, how: str):
    """Rank 1 raises (``how="raise"``) or hangs (``"hang"``); the others
    return their rank."""
    if world.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 raised on purpose")
        import time

        time.sleep(600)
    return world.rank
