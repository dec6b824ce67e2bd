"""CUDA kernels of repro_torch against their plain versions, on the card.

Every test carries the ``cuda`` marker and skips (inside the ``cuda``
fixture, never at import) when no CUDA device is present.  Run on a GPU
machine with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package: the GPU machine has no
JAX.  Inputs are integer-valued unless stated, so every result must be bit
equal; random float32 inputs are compared at rtol=atol=2e-4, the tolerance
of tests/test_kernels.py (sums are taken in another order than the plain
version's).
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.api import SparseMatrix
from repro_torch.core import distributed as D
from repro_torch.core import formats as F
from repro_torch.core.partition import (partition_1d, partition_1d_coalesced,
                                        partition_2d)
from repro_torch.kernels import _build, instrument, ops
from repro_torch.kernels import coo_spmv as coo_mod
from repro_torch.kernels.bcsr_spmv import (ROUTES, bcoo_spmv, bcoo_spmv_cuda,
                                           bcoo_spmv_plain, block_route,
                                           block_row_ptr, route_takes)
from repro_torch.kernels.coo_spmv import (ChunkPlan, coo_spmv, coo_spmv_plain,
                                          plan_chunks)
from repro_torch.kernels.ell_spmv import dense_to_ell, ell_spmv, ell_spmv_plain

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
          torch.int16, torch.int32]
BATCHES = [None, 8, 40]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape)


def _matrix(rng, m, n, density, dtype, integer=True):
    mask = rng.random((m, n)) < density
    vals = _ints(rng, (m, n)) if integer else rng.standard_normal((m, n))
    return torch.from_numpy(mask * vals).to(dtype)


def _x(rng, n, batch, dtype, integer=True):
    shape = (n,) if batch is None else (n, batch)
    vals = _ints(rng, shape, -2, 3) if integer else rng.standard_normal(shape)
    return torch.from_numpy(vals).to(dtype)


def _coo_plan(a, chunk=64, span=64, row_granular=False):
    ri, ci, vals, _ = F.nonzero(a)
    return plan_chunks(ri, ci, vals, a.shape[0], chunk=chunk, span=span,
                       row_granular=row_granular)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("row_granular", [False, True])
def test_coo_kernel_matches_plain(cuda, dtype, batch, row_granular):
    rng = np.random.default_rng(1)
    a = _matrix(rng, 300, 200, 0.1, dtype)
    a[17] = torch.from_numpy(_ints(rng, 200)).to(dtype)  # a row over one chunk
    plan = _coo_plan(a, row_granular=row_granular)
    x = _x(rng, 200, batch, dtype)
    want = coo_spmv_plain(plan, x)
    got = coo_spmv(plan.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES + [64])
@pytest.mark.parametrize("block", [(8, 16), (4, 8), (8, 128), (16, 16)])
def test_bcoo_kernel_matches_plain(cuda, dtype, batch, block):
    rng = np.random.default_rng(2)
    r, c = block
    a = _matrix(rng, r * 24, c * 10, 0.08, dtype)
    a[: r * 3] = 0  # empty block-rows are written as zeros
    m = F.dense_to_bcoo(a, block=block)
    x = _x(rng, c * 10, batch, dtype)
    want = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
    d = m.to(cuda)
    got = bcoo_spmv(d.browind, d.bcolind, d.bvalues, x.to(cuda), d.rows, d.nblocks)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def _block_case(rng, block, dtype, integer=True, n_cut=0):
    """A (24 r) x (10 c - n_cut) matrix in (r, c) blocks with three empty
    block-rows; n_cut > 0 leaves the last block-column partial (x is
    shorter than the blocks)."""
    r, c = block
    a = _matrix(rng, r * 24, c * 10, 0.08, dtype, integer)
    a[: r * 3] = 0
    if n_cut:
        a[:, c * 10 - n_cut:] = 0
    return F.dense_to_bcoo(a, block=block), c * 10 - n_cut


def _routes(dtype, block, batch):
    B = 1 if batch is None else batch
    return [rt for rt in ROUTES if route_takes(rt, dtype, *block, B)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("block", [(8, 16), (4, 8), (8, 128), (16, 16)])
@pytest.mark.parametrize("n_cut", [0, 5], ids=["whole", "partial-last-bcol"])
def test_bcoo_every_route_matches_plain(cuda, dtype, block, n_cut):
    """Integer-valued inputs: every route that takes the shape is bit-equal
    to the plain version, at B = 1, 8, 40 and 64, also when the last
    block-column is cut short by x."""
    rng = np.random.default_rng(22)
    m, n = _block_case(rng, block, dtype, n_cut=n_cut)
    d = m.to(cuda)
    ptr = block_row_ptr(d.browind, d.nblocks, d.block_rows)
    for batch in BATCHES + [64]:
        x = _x(rng, n, batch, dtype)
        want = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
        for route in _routes(dtype, block, batch):
            got = bcoo_spmv_cuda(ptr, d.bcolind, d.bvalues, x.to(cuda), d.rows,
                                 route=route)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.cpu(), want), (route, batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
@pytest.mark.parametrize("block", [(8, 16), (16, 16)])
def test_bcoo_every_route_at_batcher_widths(cuda, dtype, block):
    """B = 2 and 4, the micro-batcher's bucket widths below 8: every route
    that takes the shape (the CUDA-core route the engine takes there, and
    the tensor cores) is bit-equal to the plain version."""
    rng = np.random.default_rng(27)
    m, n = _block_case(rng, block, dtype, n_cut=0)
    d = m.to(cuda)
    ptr = block_row_ptr(d.browind, d.nblocks, d.block_rows)
    for batch in (2, 4):
        assert block_route(dtype, *block, batch) == "rows"
        x = _x(rng, n, batch, dtype)
        want = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
        for route in _routes(dtype, block, batch):
            got = bcoo_spmv_cuda(ptr, d.bcolind, d.bvalues, x.to(cuda), d.rows,
                                 route=route)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (route, batch)


def test_bcoo_route_choice_on_card(cuda):
    """The main path's (8, 16) f32 blocks take the warp at B = 1 and the
    tensor cores at B = 8 and 64; a route that cannot take a shape raises."""
    assert [block_route(torch.float32, 8, 16, B) for B in (1, 8, 64)] == \
        ["warp", "mma", "mma"]
    rng = np.random.default_rng(23)
    m, n = _block_case(rng, (8, 16), torch.int32)
    d = m.to(cuda)
    ptr = block_row_ptr(d.browind, d.nblocks, d.block_rows)
    with pytest.raises(ValueError, match="route"):
        bcoo_spmv_cuda(ptr, d.bcolind, d.bvalues,
                       _x(rng, n, 8, torch.int32).to(cuda), d.rows, route="mma")


@pytest.mark.parametrize("batch", [None, 8, 40, 64])
@pytest.mark.parametrize("block", [(8, 16), (16, 16), (4, 8)])
def test_bcoo_random_f32_every_route(cuda, batch, block):
    """Random float32 holds 2e-4 on every route (3xTF32 on the tensor
    cores)."""
    rng = np.random.default_rng(24)
    m, n = _block_case(rng, block, torch.float32, integer=False)
    d = m.to(cuda)
    ptr = block_row_ptr(d.browind, d.nblocks, d.block_rows)
    x = _x(rng, n, batch, torch.float32, integer=False)
    want = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
    for route in _routes(torch.float32, block, batch):
        got = bcoo_spmv_cuda(ptr, d.bcolind, d.bvalues, x.to(cuda), d.rows,
                             route=route)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def test_bcoo_spmm_columns_equal_spmv(cuda):
    """(8, 16) f32, integer-valued: the tensor-core SpMM's columns equal
    the warp SpMV run column by column."""
    rng = np.random.default_rng(25)
    m, n = _block_case(rng, (8, 16), torch.float32)
    d = m.to(cuda)
    for batch in (8, 40, 64):
        X = _x(rng, n, batch, torch.float32).to(cuda)
        Y = bcoo_spmv(d.browind, d.bcolind, d.bvalues, X, d.rows, d.nblocks)
        cols = torch.stack([bcoo_spmv(d.browind, d.bcolind, d.bvalues,
                                      X[:, j].contiguous(), d.rows, d.nblocks)
                            for j in range(batch)], 1)
        assert torch.equal(Y, cols)


@pytest.mark.parametrize("batch", BATCHES)
def test_kernels_random_f32_within_tolerance(cuda, batch):
    rng = np.random.default_rng(3)
    a = _matrix(rng, 256, 512, 0.1, torch.float32, integer=False)
    x = _x(rng, 512, batch, torch.float32, integer=False)
    plan = _coo_plan(a)
    torch.testing.assert_close(coo_spmv(plan.to(cuda), x.to(cuda)).cpu(),
                               coo_spmv_plain(plan, x), rtol=2e-4, atol=2e-4)
    m = F.dense_to_bcoo(a, block=(8, 16))
    d = m.to(cuda)
    got = bcoo_spmv(d.browind, d.bcolind, d.bvalues, x.to(cuda), d.rows, d.nblocks)
    want = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def test_kernels_raise_on_f64_and_i64(cuda):
    rng = np.random.default_rng(4)
    for dtype in (torch.float64, torch.int64):
        a = _matrix(rng, 64, 64, 0.2, dtype)
        plan = _coo_plan(a).to(cuda)
        with pytest.raises(TypeError):
            coo_spmv(plan, _x(rng, 64, None, dtype).to(cuda))
        m = F.dense_to_bcoo(a, block=(8, 16)).to(cuda)
        with pytest.raises(TypeError):
            bcoo_spmv(m.browind, m.bcolind, m.bvalues,
                      _x(rng, 64, None, dtype).to(cuda), m.rows, m.nblocks)


def test_kernels_raise_on_mismatched_inputs(cuda):
    rng = np.random.default_rng(5)
    a = _matrix(rng, 64, 64, 0.2, torch.float32)
    plan = _coo_plan(a)
    x = _x(rng, 64, None, torch.float32)
    with pytest.raises(ValueError):  # plan left on the host
        coo_spmv(plan, x.to(cuda))
    with pytest.raises(TypeError):  # x dtype differs from the values'
        coo_spmv(plan.to(cuda), x.to(cuda, torch.int32))
    m = F.dense_to_bcoo(a, block=(8, 16)).to(cuda)
    ptr = block_row_ptr(m.browind, m.nblocks, m.block_rows)
    with pytest.raises(ValueError):  # pointer of the wrong length
        bcoo_spmv_cuda(ptr[:-1].contiguous(), m.bcolind, m.bvalues, x.to(cuda),
                       m.rows)


def test_launch_count_one_per_call(cuda):
    rng = np.random.default_rng(6)
    a = _matrix(rng, 128, 96, 0.1, torch.float32)
    instrument.reset()
    for fmt in ("coo", "csr", "bcoo", "bcsr"):
        exe = SparseMatrix.from_dense(a).plan(fmt=fmt, block=(8, 16)).compile()
        exe(_x(rng, 96, None, torch.float32).numpy())
        exe.batch(_x(rng, 96, 40, torch.float32).numpy())
    torch.cuda.synchronize()
    assert instrument.launches("coo") == 4 and instrument.launches("coo.spmm") == 2
    assert instrument.launches("bcoo") == 4 and instrument.launches("bcoo.spmm") == 2
    # the plain versions launch nothing
    instrument.reset()
    plan = _coo_plan(a)
    coo_spmv_plain(plan.to(cuda), _x(rng, 96, None, torch.float32).to(cuda))
    assert instrument.launches() == 0


@pytest.mark.parametrize("kind", ["coo", "bcoo"])
def test_batch_tile_invariance(cuda, kind):
    """Random float32: every batch tile gives the same bits (fixed sum order)."""
    rng = np.random.default_rng(7)
    a = _matrix(rng, 256, 160, 0.15, torch.float32, integer=False)
    X = _x(rng, 160, 40, torch.float32, integer=False).to(cuda)
    if kind == "coo":
        plan = _coo_plan(a).to(cuda)
        runs = [coo_spmv(plan, X, bt) for bt in (1, 2, 4, 8, 13, 32)]
        runs.append(torch.stack([coo_spmv(plan, X[:, j].contiguous())
                                 for j in range(40)], 1))
    else:
        m = F.dense_to_bcoo(a, block=(8, 16)).to(cuda)
        runs = [bcoo_spmv(m.browind, m.bcolind, m.bvalues, X, m.rows, m.nblocks,
                          bt) for bt in (1, 2, 4, 8, 13, 32)]
        ptr = block_row_ptr(m.browind, m.nblocks, m.block_rows)
        rows = [bcoo_spmv_cuda(ptr, m.bcolind, m.bvalues, X, m.rows, bt,
                               route="rows") for bt in (1, 2, 4, 8, 13, 32)]
        assert all(torch.equal(y, rows[0]) for y in rows[1:])
    for y in runs[1:]:
        assert torch.equal(y, runs[0])


def test_empty_matrix_launches_nothing(cuda):
    a = torch.zeros((64, 48))
    plan = _coo_plan(a).to(cuda)
    instrument.reset()
    y = coo_spmv(plan, torch.ones(48, device=cuda))
    assert torch.equal(y.cpu(), torch.zeros(64)) and instrument.launches() == 0


@pytest.mark.parametrize("fmt", ["coo", "csr", "bcoo", "bcsr"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
def test_pipeline_on_card_matches_torch_impl(cuda, fmt, dtype):
    rng = np.random.default_rng(8)
    a = _matrix(rng, 200, 128, 0.1, dtype)
    sm = SparseMatrix.from_dense(a)
    x = _x(rng, 128, None, dtype)
    X = _x(rng, 128, 3, dtype)
    ref = sm.plan(fmt=fmt, impl="torch", device="cpu").compile()
    exe = sm.plan(fmt=fmt).compile()  # impl="cuda", device="cuda"
    assert exe.device.type == "cuda"
    np.testing.assert_array_equal(exe(x), ref(x).astype(exe(x).dtype))
    np.testing.assert_array_equal(exe.batch(X), ref.batch(X).astype(exe(x).dtype))
    assert np.array_equal(ops.spmv(sm.container(fmt).to(cuda), x.to(cuda),
                                   impl="cuda").cpu().numpy(), exe(x))


# ------------------------------------------------------------------- ELL


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("k_pad", [None, 3])
def test_ell_kernel_matches_plain(cuda, dtype, batch, k_pad):
    rng = np.random.default_rng(9)
    a = _matrix(rng, 300, 200, 0.05, dtype)
    a[11] = torch.from_numpy(_ints(rng, 200)).to(dtype)  # K = a full row
    ci, vv, rn = dense_to_ell(a, k=k_pad)
    x = _x(rng, 200, batch, dtype)
    want = ell_spmv_plain(ci, vv, rn, x)
    instrument.reset()
    got = ell_spmv(ci.to(cuda), vv.to(cuda), rn.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert instrument.launches("ell") == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_ell_masked_clipped_and_tile_invariant(cuda):
    rng = np.random.default_rng(10)
    ci = torch.from_numpy(rng.integers(-5, 80, (257, 6)).astype(np.int32))
    vv = torch.from_numpy(rng.standard_normal((257, 6)).astype(np.float32))
    rn = torch.from_numpy(rng.integers(0, 8, 257).astype(np.int32))
    X = _x(rng, 64, 40, torch.float32, integer=False)
    want = ell_spmv_plain(ci, vv, rn, X)
    args = [t.to(cuda) for t in (ci, vv, rn, X)]
    runs = [ell_spmv(*args, bt) for bt in (1, 2, 8, 13, 32)]
    torch.testing.assert_close(runs[0].cpu(), want, rtol=2e-4, atol=2e-4)
    for y in runs[1:]:
        assert torch.equal(y, runs[0])


# ------------------------------------------------------------- part axis


def _parts(rng, fmt, scheme, dtype):
    a = _matrix(rng, 96, 128, 0.12, dtype)
    a[21] = torch.from_numpy(_ints(rng, 128)).to(dtype)  # split by 1d.nnz
    head, tail = scheme.split(".")
    if head == "1d":
        return partition_1d(a, 4, fmt, tail, (8, 16)), a
    return partition_2d(a, (2, 2), fmt, tail, (8, 16)), a


PART_CASES = [("coo", "1d.nnz"), ("csr", "1d.nnz-rgrn"),
              ("coo", "2d.variable-sized"), ("coo", "2d.equally-sized"),
              ("bcoo", "1d.nnz"), ("bcoo", "2d.variable-sized"),
              ("bcsr", "2d.equally-wide")]


@pytest.mark.parametrize("fmt,scheme", PART_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_part_axis_launch_equals_single_part_launches(cuda, fmt, scheme, dtype,
                                                      batch):
    """One launch over P parts == P single-part launches (each on its own x
    window) == the per-part plain versions, bit for bit."""
    rng = np.random.default_rng(11)
    part, _ = _parts(rng, fmt, scheme, dtype)
    P = part.n_parts
    width = part.w_pad
    offsets = [0] * P if scheme.startswith("1d") else part.col_start.tolist()
    x = _x(rng, max(offsets) + width, batch, dtype).to(cuda)
    win = _build.XWindows.build(offsets, width, cuda)
    dev = part.to(cuda)
    if fmt in ("coo", "csr"):
        arrs = {k[6:]: v.to(cuda) for k, v in D.kernel_chunk_arrays(part).items()}
        span = D._span(part.h_pad)
        plan = ChunkPlan(**arrs, n_windows=-(-part.h_pad // span),
                         out_rows=part.h_pad, span=span)
        instrument.reset()
        got = coo_spmv(plan, x, windows=win)
        assert instrument.launches("coo") == 1
        singles = [coo_spmv(plan.part(p), win.local(x, p)) for p in range(P)]
        plains = coo_spmv_plain(plan, x, win)
    else:
        ptr = D.kernel_block_arrays(part)["browptr"].to(cuda)
        instrument.reset()
        got = bcoo_spmv(dev.rowind, dev.colind, dev.values, x, part.h_pad,
                        dev.nnz, browptr=ptr, windows=win)
        assert instrument.launches("bcoo") == 1
        singles = [bcoo_spmv(dev.rowind[p], dev.colind[p], dev.values[p],
                             win.local(x, p), part.h_pad, dev.nnz[p],
                             browptr=ptr[p]) for p in range(P)]
        plains = bcoo_spmv_plain(dev.rowind, dev.colind, dev.values, x,
                                 part.h_pad, dev.nnz, win)
    torch.cuda.synchronize()
    assert got.shape[0] == P and torch.equal(got, torch.stack(singles))
    assert torch.equal(got, plains)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
@pytest.mark.parametrize("batch", [None, 8, 10, 40])
def test_part_axis_unaligned_x_windows(cuda, dtype, batch):
    """Block parts whose x windows start one row past their columns, so that
    x_offset * B * 4 is not a multiple of 16 (B = 1 and 10): the kernel
    takes scalar x loads there and still equals the per-part plain
    versions and the single-part launches."""
    rng = np.random.default_rng(26)
    part, _ = _parts(rng, "bcoo", "2d.variable-sized", dtype)
    P, width = part.n_parts, part.w_pad
    offsets = [o + 1 for o in part.col_start.tolist()]
    B = 1 if batch is None else batch
    if B in (1, 10):
        assert any(o * B * 4 % 16 for o in offsets)
    x = _x(rng, max(offsets) + width, batch, dtype).to(cuda)
    win = _build.XWindows.build(offsets, width, cuda)
    dev = part.to(cuda)
    ptr = D.kernel_block_arrays(part)["browptr"].to(cuda)
    got = bcoo_spmv(dev.rowind, dev.colind, dev.values, x, part.h_pad, dev.nnz,
                    browptr=ptr, windows=win)
    singles = [bcoo_spmv(dev.rowind[p], dev.colind[p], dev.values[p],
                         win.local(x, p), part.h_pad, dev.nnz[p], browptr=ptr[p])
               for p in range(P)]
    plains = bcoo_spmv_plain(dev.rowind, dev.colind, dev.values, x, part.h_pad,
                             dev.nnz, win)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.stack(singles)) and torch.equal(got, plains)


def test_part_axis_rejects_windows_that_overrun_x(cuda):
    rng = np.random.default_rng(12)
    part, _ = _parts(rng, "bcoo", "2d.variable-sized", torch.float32)
    dev = part.to(cuda)
    ptr = D.kernel_block_arrays(part)["browptr"].to(cuda)
    win = _build.XWindows.build(part.col_start.tolist(), part.w_pad, cuda)
    x = torch.zeros(max(part.col_start.tolist()) + part.w_pad - 1, device=cuda)
    with pytest.raises(ValueError, match="overrun"):
        bcoo_spmv(dev.rowind, dev.colind, dev.values, x, part.h_pad, dev.nnz,
                  browptr=ptr, windows=win)


@pytest.mark.parametrize("scheme,fmt,merge", [
    ("1d.nnz", "coo", None), ("1d.rows", "csr", None),
    ("1d.nnz", "bcoo", None), ("2d.equally-sized", "coo", "psum_scatter"),
    ("2d.equally-sized", "bcsr", "psum"), ("2d.equally-wide", "coo", None),
    ("2d.variable-sized", "bcoo", None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
def test_mesh_executor_on_card_matches_cpu(cuda, scheme, fmt, merge, dtype):
    """P parts on the card answer as the same plan on the CPU (the plain
    versions there), one part-axis launch per request."""
    rng = np.random.default_rng(13)
    a = _matrix(rng, 96, 128, 0.12, dtype)
    a[21] = torch.from_numpy(_ints(rng, 128)).to(dtype)
    sm = SparseMatrix.from_dense(a)
    kw = dict(scheme=scheme, fmt=fmt, merge=merge, block=(8, 16))
    ref = sm.plan(devices=["cpu"] * 4, **kw).compile()
    exe = sm.plan(devices=["cuda"] * 4, **kw).compile()
    assert exe.device.type == "cuda" and exe.plan.scheme_id == ref.plan.scheme_id
    x, X = _x(rng, 128, None, dtype), _x(rng, 128, 40, dtype)
    instrument.reset()
    np.testing.assert_array_equal(exe(x), ref(x))
    np.testing.assert_array_equal(exe.batch(X), ref.batch(X))
    kind = "coo" if fmt in ("coo", "csr") else "bcoo"
    assert instrument.launches(kind) == 2 and instrument.launches() == 3


# ------------------------------------------------------------- heavy windows


def _heavy_triplets(rng, dtype, integer=True, m=1024, n=262144, heavy=200000,
                    row=300):
    """m x n with 8 nonzeros in every row and one row of ``heavy``: its
    window is split into pieces of the CUDA kernel.  Random values of the
    heavy row are scaled by 1/sqrt(heavy), so that its sum has unit spread
    and the 2e-4 tolerance is not spent on float32's rounding of a
    200,000-term sum."""
    rows = np.concatenate([np.repeat(np.arange(m), 8), np.full(heavy, row)])
    cols = np.concatenate([rng.integers(0, n, m * 8),
                           np.sort(rng.choice(n, heavy, replace=False))])
    key = np.unique(rows * n + cols)
    vals = _ints(rng, len(key)) if integer else rng.standard_normal(len(key))
    vals = np.where(vals == 0, 1, vals)
    if not integer:
        vals = np.where(key // n == row, vals / np.sqrt(heavy), vals)
    return key // n, key % n, torch.from_numpy(vals).to(dtype), (m, n)


@pytest.fixture(scope="module")
def heavy_plans():
    """Single-device and 4-part plans of the heavy matrix, per dtype (host)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            ri, ci, v, shape = _heavy_triplets(np.random.default_rng(14), dtype)
            plan = plan_chunks(ri, ci, v, shape[0])
            part = partition_1d_coalesced(ri, ci, v, shape, 4, "coo", "nnz")
            cache[dtype] = plan, part, shape
        return cache[dtype]
    return get


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_heavy_window_single_device(cuda, heavy_plans, dtype, batch):
    plan, _, (m, n) = heavy_plans(dtype)
    assert plan.splits.shape[0] >= 200000 // (coo_mod.CHUNK_E *
                                               coo_mod.PIECE_CHUNKS)
    x = _x(np.random.default_rng(15), n, batch, dtype)
    want = coo_spmv_plain(plan, x)
    instrument.reset()
    got = coo_spmv(plan.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert instrument.launches("coo") == 1  # the merge pass is not counted
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_heavy_window_part_axis(cuda, heavy_plans, dtype, batch):
    _, part, (m, n) = heavy_plans(dtype)
    arrs = {k[6:]: v.to(cuda) for k, v in D.kernel_chunk_arrays(part).items()}
    span = D._span(part.h_pad)
    plan = ChunkPlan(**arrs, n_windows=-(-part.h_pad // span),
                     out_rows=part.h_pad, span=span)
    assert (plan.splits[..., 0] >= 0).any()  # some part splits a window
    x = _x(np.random.default_rng(16), n, batch, dtype).to(cuda)
    got = coo_spmv(plan, x)
    singles = [coo_spmv(plan.part(p), x) for p in range(part.n_parts)]
    torch.cuda.synchronize()
    assert torch.equal(got, torch.stack(singles))
    assert torch.equal(got.cpu(), coo_spmv_plain(plan.to("cpu"), x.cpu()))


@pytest.mark.parametrize("extra", [0, 1], ids=["M", "M+1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_windows_of_M_and_M_plus_1_chunks(cuda, extra, dtype, batch):
    """A window of exactly M chunks is one piece; M + 1 chunks are two,
    merged by the second pass.  Both equal the plain version."""
    rng = np.random.default_rng(17)
    M, E = coo_mod.PIECE_CHUNKS, 64
    n_el = M * E + extra
    a = torch.zeros((128, n_el + 64), dtype=dtype)
    a[5, :n_el] = torch.from_numpy(_ints(rng, n_el, 1, 3)).to(dtype)  # window 0
    a[70] = torch.from_numpy(_ints(rng, n_el + 64, 1, 3)).to(dtype)  # window 1
    plan = _coo_plan(a, chunk=E)
    assert int(plan.window_start[1]) == M + extra
    assert (plan.pieces[:, 0] == 0).sum() == 1 + extra
    x = _x(rng, n_el + 64, batch, dtype)
    got = coo_spmv(plan.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), coo_spmv_plain(plan, x))


def test_heavy_window_batch_tiles_are_bit_identical(cuda):
    """Random float32 on a split window: batch tiles 8 and 32 and the
    column-by-column SpMV give the same bits (the order is the plan's)."""
    ri, ci, v, (m, n) = _heavy_triplets(np.random.default_rng(18), torch.float32,
                                        integer=False)
    plan = plan_chunks(ri, ci, v, m).to(cuda)
    X = _x(np.random.default_rng(19), n, 40, torch.float32, integer=False).to(cuda)
    y8, y32 = coo_spmv(plan, X, 8), coo_spmv(plan, X, 32)
    cols = torch.stack([coo_spmv(plan, X[:, j].contiguous()) for j in range(40)], 1)
    assert torch.equal(y8, y32) and torch.equal(y8, cols)
    torch.testing.assert_close(y8.cpu(), coo_spmv_plain(plan.to("cpu"), X.cpu()),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=str)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("K", [48, 3])
def test_ell_unaligned_tiles(cuda, dtype, batch, K):
    """K = 48 and K = 3 with 1,001 rows: the last tile's runs are not a
    multiple of 16 bytes, and its tail goes by ordinary loads."""
    rng = np.random.default_rng(20)
    a = _matrix(rng, 1001, 300, 0.1, dtype)
    ci, vv, rn = dense_to_ell(a, k=K)
    x = _x(rng, 300, batch, dtype)
    want = ell_spmv_plain(ci, vv, rn, x)
    got = ell_spmv(ci.to(cuda), vv.to(cuda), rn.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    if batch is not None:
        assert torch.equal(ell_spmv(ci.to(cuda), vv.to(cuda), rn.to(cuda),
                                    x.to(cuda), 8), got)


def test_ell_rows_too_long_for_a_tile(cuda):
    """K = 20,000 f32 slots a row do not fit 16 rows in shared memory: the
    kernel takes a thread per (row, column) from global memory instead."""
    rng = np.random.default_rng(21)
    a = _matrix(rng, 40, 20000, 0.9, torch.float32)
    ci, vv, rn = dense_to_ell(a)
    assert ci.shape[1] > 14000
    for batch in (None, 8):
        x = _x(rng, 20000, batch, torch.float32)
        got = ell_spmv(ci.to(cuda), vv.to(cuda), rn.to(cuda), x.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ell_spmv_plain(ci, vv, rn, x))


# ------------------------------------------------------------ serving path

def _serve_matrix(fmt_seed: int, block: bool):
    """A 512 x 768 integer-valued matrix: random scalars, or (8, 16) blocks."""
    rng = np.random.default_rng(fmt_seed)
    if not block:
        return _matrix(rng, 512, 768, 0.05, torch.float32)
    mask = np.kron(rng.random((64, 48)) < 0.15, np.ones((8, 16)))
    return torch.from_numpy(mask * _ints(rng, (512, 768))).float()


SERVE_CASES = [("coo", None, False), ("csr", None, False), ("bcoo", None, True),
               ("bcsr", None, True), ("coo", "1d", False), ("bcoo", "2d", True)]


@pytest.mark.parametrize("fmt,partitioning,block", SERVE_CASES)
@pytest.mark.parametrize("parts", [1, 4])
def test_engine_on_card_matches_plain_versions(cuda, fmt, partitioning, block,
                                               parts):
    """The engine on the card against the same engine on the CPU (the
    kernels' plain versions) at B = 1, 2, 4 and 8; one part-axis launch a
    multiply."""
    from repro_torch.core.adaptive import Plan
    from repro_torch.engine import SpmvEngine

    a = _serve_matrix(len(fmt) + parts, block)
    plan = None
    if partitioning is None:
        plan = Plan("2d", "equally-sized", fmt, "psum_scatter", (1, 1), "forced")
    engines = [SpmvEngine(devices=[d] * parts)
               for d in (cuda, torch.device("cpu"))]
    for eng in engines:
        eng.register("m", a, plan=plan, partitioning=partitioning)
    card, cpu = engines
    assert card.registry.get("m").plan.fmt == cpu.registry.get("m").plan.fmt
    rng = np.random.default_rng(23)
    instrument.reset()
    for batch in (None, 2, 4, 8):
        x = _x(rng, 768, batch, torch.float32)
        got, want = card.multiply("m", x), cpu.multiply("m", x)
        assert got.dtype == want.dtype and np.array_equal(got, want), batch
    kind = "bcoo" if card.registry.get("m").plan.fmt in ("bcoo", "bcsr") \
        else "coo"
    assert instrument.launches(kind) == 4
    assert instrument.launches(kind + ".spmm") == 3


def test_engine_eviction_frees_card_memory(cuda):
    from repro_torch.engine import SpmvEngine

    eng = SpmvEngine(devices=[cuda], cache_capacity=1)
    rng = np.random.default_rng(24)
    eng.register("a", _matrix(rng, 4096, 4096, 0.05, torch.float32))
    cp = eng.plan_for("a")
    placed = sum(t.numel() * t.element_size() for t in cp.arrays.values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.register("b", _matrix(rng, 64, 64, 0.05, torch.float32))  # evicts a
    torch.cuda.synchronize()
    assert cp.arrays is None
    assert before - torch.cuda.memory_allocated() >= placed - (1 << 20)


def test_one_launch_per_coalesced_batch_under_two_threads(cuda):
    """The batcher flushing on one host thread while explicit batches run
    on another: every answer is right and the launches equal the engine's
    multiplies (one part-axis launch each)."""
    import threading

    from repro_torch.engine import MicroBatcher, SpmvEngine

    a = _serve_matrix(25, True)
    eng = SpmvEngine(devices=[cuda])
    eng.register("m", a)
    mb = MicroBatcher(eng, max_batch=8, auto_flush=False)
    rng = np.random.default_rng(26)
    vecs = [_x(rng, 768, None, torch.float32).numpy() for _ in range(40)]
    batches = [_x(rng, 768, 4, torch.float32).numpy() for _ in range(10)]
    a_np = a.numpy()
    instrument.reset()
    errors = []

    def submitter():
        try:
            futs = []
            for k, v in enumerate(vecs):
                futs.append(mb.submit("m", v))
                if k % 5 == 4:
                    mb.flush()
            mb.flush()
            for f, v in zip(futs, vecs):
                assert np.array_equal(f.result(timeout=60), a_np @ v)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    def explicit():
        try:
            for X in batches:
                assert np.array_equal(eng.multiply("m", X), a_np @ X)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=submitter),
               threading.Thread(target=explicit)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    multiplies = mb.batches_run + len(batches)
    assert eng.telemetry.breakdown("m")["requests"] == multiplies
    assert instrument.launches("bcoo") == multiplies


# ------------------------------------------------------- solver sessions

def _solver_square(seed: int, n: int = 512, per_row: int = 3):
    """n x n: ``per_row`` off-diagonal entries in {-1, 1} per row and a
    diagonal of 4 (row sums of |a| <= 7): 5 plain steps from x0 in {-2..2}
    stay below 2^24, and Richardson (omega 1/4) and Jacobi stay dyadic, so
    every sum is exact."""
    rng = np.random.default_rng(seed)
    a = 4.0 * np.eye(n, dtype=np.float32)
    rows = np.repeat(np.arange(n), per_row)
    cols = (rows + rng.integers(1, n, n * per_row)) % n
    a[rows, cols] = rng.choice([-1.0, 1.0], n * per_row)
    return a


SOLVER_PLANS = [(fmt, None) for fmt in ("coo", "csr", "bcoo", "bcsr")]
SOLVER_PLANS += [("coo", "1d"), ("csr", "2d"), ("bcoo", "1d"), ("bcsr", "2d")]


@pytest.mark.parametrize("fmt,scheme", SOLVER_PLANS)
@pytest.mark.parametrize("combine", ["plain", "richardson", "jacobi"])
def test_iterate_on_card_equals_host_loop(cuda, fmt, scheme, combine):
    """k steps on the card: bit-equal to k host ``exe(x)`` calls and to the
    session on the CPU (the plain versions), k kernel launches."""
    import _solver_runner as sr

    a = _solver_square(len(fmt) + (scheme == "2d"))
    rng = np.random.default_rng(31)
    x0 = rng.integers(-2, 3, 512).astype(np.float32)
    b = rng.integers(-3, 4, 512).astype(np.float32)
    kw = {"plain": {}, "richardson": dict(b=b, omega=0.25),
          "jacobi": dict(b=b, diag=np.diag(a).copy())}[combine]
    sm = SparseMatrix.from_dense(a)
    plan_kw = dict(fmt=fmt, block=(8, 16))
    exes = [sm.plan(device=d, **plan_kw) if scheme is None else
            sm.plan(scheme=scheme, devices=[d] * 4, **plan_kw)
            for d in (cuda, torch.device("cpu"))]
    card, cpu = [p.compile() for p in exes]
    instrument.reset()
    res = card.iterate(x0, steps=5, combine=combine, **kw)
    kind = "bcoo" if fmt in ("bcoo", "bcsr") else "coo"
    assert instrument.launches(kind) == 5 and instrument.launches() == 5
    want = cpu.iterate(x0, steps=5, combine=combine, **kw)
    np.testing.assert_array_equal(res.x, want.x)
    np.testing.assert_array_equal(res.x, sr.host_loop(card, x0, 5, combine,
                                                      **kw))
    assert res.steps == 5 and res.kernel_s > 0


def test_iterate_on_card_bf16_casts_each_f32_result_back(cuda):
    a = torch.from_numpy(_solver_square(9, per_row=2)).to(torch.bfloat16)
    x0 = torch.from_numpy(np.random.default_rng(32).integers(
        -2, 3, 512).astype(np.float32)).to(torch.bfloat16)
    exe = SparseMatrix.from_dense(a).plan(device=cuda).compile()
    res = exe.iterate(x0, steps=3)
    y = x0
    for _ in range(3):
        y = exe(y)  # float32 host rows (the kernels' accumulation dtype)
        assert y.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(res.x, np.float32),
                                  torch.from_numpy(y).to(torch.bfloat16)
                                  .float().numpy())


def test_iterate_steps_mode_never_syncs_the_host(cuda):
    """The loop body (kernel launch + combine) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: any host read or blocking
    copy between steps would raise."""
    from repro_torch.api.iterate import _build_loop, make_combine

    a = _solver_square(33)
    for kw in (dict(fmt="coo", device=cuda),
               dict(scheme="2d", devices=[cuda] * 4, fmt="csr")):
        exe = SparseMatrix.from_dense(a).plan(**kw).compile()
        for name in ("power", "cg"):
            comb = make_combine(name)
            params = {"omega": torch.ones((), device=cuda),
                      "b": torch.ones(512, device=cuda)}
            x0 = torch.ones(512, device=cuda)
            loop = _build_loop(comb, 6, 0, 0)
            apply = exe._iterate_apply()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                carry, k = loop(apply, x0, params, None)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert k == 6 and bool(torch.isfinite(carry["x"]).all())


@pytest.mark.parametrize("impl_fmt", [("cuda", "csr"), ("cuda", "coo")])
def test_pinned_solver_counts_on_card(cuda, impl_fmt):
    """CG 11 and PageRank 12 steps to tolerance, and max_steps=17 never
    converged, on the CUDA kernels (the counts of tests/test_solver.py)."""
    import _solver_runner as sr

    _, fmt = impl_fmt

    def exe(a):
        return SparseMatrix.from_dense(a).plan(fmt=fmt, device=cuda).compile()

    n = 64
    a = sr.spd_laplacian(n)
    b = np.random.default_rng(1).integers(-2, 3, n).astype(np.float32)
    res = exe(a).iterate(np.zeros(n, np.float32), tol=1e-5, combine="cg",
                         b=b, max_steps=200, check_every=1)
    assert res.converged and res.steps == 11
    g = sr.pagerank_matrix(32, seed=5)
    res = exe(g).iterate(np.full(32, 1.0 / 32, np.float32), tol=1e-6,
                         combine="power", max_steps=100, check_every=4)
    assert res.converged and res.steps == 12
    x0 = np.random.default_rng(0).standard_normal(24).astype(np.float32)
    res = exe((-np.eye(24)).astype(np.float32)).iterate(
        x0, tol=1e-9, combine="power", max_steps=17, check_every=5)
    assert not res.converged and res.steps == 17


def test_thread_phase_times_exclude_another_threads_kernel(cuda):
    """One thread holds its own stream busy (``torch.cuda._sleep``, about
    1 s); meanwhile another thread's place / run_raw / assemble, a solver
    session and an engine multiply finish in a fraction of that: each
    waits on its own stream, never on the device."""
    import threading
    import time

    from repro_torch.core.streams import on_thread_stream, wait
    from repro_torch.engine import SpmvEngine

    a = _solver_square(34)
    x = np.random.default_rng(35).integers(-2, 3, 512).astype(np.float32)
    sm = SparseMatrix.from_dense(a)
    mesh = sm.plan(scheme="2d", devices=[cuda] * 4).compile()
    single = sm.plan(device=cuda).compile()
    eng = SpmvEngine(devices=[cuda])
    eng.register("m", a)
    single.iterate(x, steps=3)  # warm every path once
    mesh(x), eng.multiply("m", x)
    # calibrate the sleep to about 1 s on this card
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * 1000.0 / start.elapsed_time(end))
    busy, released = threading.Event(), threading.Event()

    def sleeper():
        with on_thread_stream(cuda):
            torch.cuda._sleep(cycles)
            busy.set()
            wait(cuda)
        released.set()

    t = threading.Thread(target=sleeper)
    t.start()
    assert busy.wait(60)
    t0 = time.perf_counter()
    xs = mesh.place(x)
    raw = mesh.run_raw(xs)
    y = mesh.assemble(raw)
    res = single.iterate(x, steps=3)
    eng.multiply("m", x)
    elapsed = time.perf_counter() - t0
    overlapped = not released.is_set()
    t.join(60)
    assert overlapped, "the sleeping kernel ended before the phases did"
    assert elapsed < 0.25, f"phases took {elapsed:.3f} s beside a 1 s kernel"
    rec = eng.telemetry.last("m")
    assert rec.load_s + rec.kernel_s + rec.retrieve_s < 0.25
    np.testing.assert_array_equal(y, a @ x)
    np.testing.assert_array_equal(res.x, np.linalg.matrix_power(
        a.astype(np.float64), 3) @ x)


def test_live_threads_get_distinct_streams(cuda):
    """16 threads take their stream at once (a short switch interval to
    mix them): no two live threads share one, and each keeps its own."""
    import sys
    import threading

    from repro_torch.core.streams import thread_stream

    n = 16
    barrier = threading.Barrier(n)
    got, errors = {}, []

    def take(i):
        try:
            s = thread_stream(cuda)
            barrier.wait(timeout=60)  # all n alive while each takes its own
            got[i] = (s.cuda_stream, thread_stream(cuda).cuda_stream)
            barrier.wait(timeout=60)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    mine = thread_stream(cuda).cuda_stream  # the main thread's, held
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=take, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(a == b for a, b in got.values())
    assert len({a for a, _ in got.values()}) == n
    assert mine not in {a for a, _ in got.values()}


# ------------------------------------------------------------ tuning

TUNE_CASES = [(False, None, 1), (True, None, 1), (True, 8, 1), (False, 8, 4),
              (True, None, 4)]


@pytest.mark.parametrize("block,batch,parts", TUNE_CASES)
def test_tune_on_card_matches_plain_versions(cuda, block, batch, parts):
    """plan(scheme="tune") on the card: every planned candidate measured
    (COO/CSR and, on a block matrix, BCOO/BCSR kernels), each measurement
    launching the kernel once per call; the winner's answers equal the
    same plan's answers on the CPU (the plain versions) bit for bit; the
    candidates release what they placed."""
    from repro_torch.api import SparseMatrix
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner

    a = _serve_matrix(31 + parts, block)
    sm = SparseMatrix.from_dense(a)
    pool = dict(devices=[cuda] * parts) if parts > 1 else dict(device=cuda)
    planned = CandidateGenerator().plans(sm, **pool)
    kinds = {"coo" if p.fmt in ("coo", "csr") else "bcoo" for p in planned}
    assert kinds == ({"coo", "bcoo"} if block else {"coo"})
    meas = Measurer(warmup=1, iters=2, trim=0)
    gc.collect()  # an earlier test's engine (a reference cycle) frees its
    # plan when the collector runs, which must not be inside the tune
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    instrument.reset()
    pln = sm.plan(scheme="tune", tuner=Tuner(measurer=meas), batch=batch, **pool)
    launched = instrument.launches("coo") + instrument.launches("bcoo")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert pln.measured["candidates"] == pln.measured["planned"] == len(planned)
    assert launched == len(planned) * 3  # warmup 1 + iters 2, one launch each
    if parts > 1:
        assert pln.measured["phases"]["kernel"] > 0
    rng = np.random.default_rng(32)
    x = _x(rng, 768, batch, torch.float32)
    exe = pln.compile()
    want = sm.plan(scheme=pln.scheme, impl=pln.impl, device="cpu",
                   **({"devices": ["cpu"] * parts} if parts > 1 else {}))
    got, ref = exe(x), want.compile()(x)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    np.testing.assert_array_equal(got, a.numpy() @ x.numpy())
    exe.release()


def test_refine_swap_while_another_thread_multiplies(cuda):
    """A refinement compiles, times and swaps plans on its own thread and
    stream while another thread multiplies: every answer before, during and
    after each swap is exact, and the launches equal the multiplies plus
    the measurements and the winners' warm-ups."""
    import threading

    from repro_torch.engine import SpmvEngine
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner

    a = _serve_matrix(33, True)
    a_np = a.numpy()
    tuner = Tuner(generator=CandidateGenerator(), measurer=Measurer(warmup=1,
                                                                    iters=2))
    eng = SpmvEngine(devices=[cuda], tune=True, tuner=tuner, tune_margin=1.0,
                     tune_after=10**9)
    eng.register("m", a)
    rng = np.random.default_rng(34)
    xs = [_x(rng, 768, (None, 4)[i % 2], torch.float32).numpy()
          for i in range(8)]
    stop, errors, served = threading.Event(), [], [0]

    def client():
        try:
            i = 0
            while not stop.is_set():
                x = xs[i % len(xs)]
                assert np.array_equal(eng.multiply("m", x), a_np @ x)
                served[0] += 1
                i += 1
        except Exception as e:  # reported below
            errors.append(repr(e))

    instrument.reset()
    thread = threading.Thread(target=client)
    thread.start()
    try:
        events = []
        for k in range(4):
            tuner.cache.clear()  # measure anew every time
            events.append(eng.refine("m", x=xs[k % 2]))
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive() and errors == []
    assert served[0] > 0
    launched = instrument.launches("coo") + instrument.launches("bcoo")
    expect = (served[0] + sum(e["candidates"] * 3 + e["swapped"] for e in events))
    assert launched == expect, (launched, expect, events)
    assert all(e["candidates"] == e["planned"] for e in events), events
    for x in xs:
        assert np.array_equal(eng.multiply("m", x), a_np @ x)


def test_engine_snapshots_a_card_input_with_an_event(cuda):
    """A card tensor as input: the traffic trigger snapshots it on the
    caller's stream with an event; the refinement measures on it."""
    from repro_torch.engine import SpmvEngine

    a = _serve_matrix(35, False)
    eng = SpmvEngine(devices=[cuda], tune=True, tune_after=2)
    eng.register("m", a)
    x = _x(np.random.default_rng(36), 768, None, torch.float32).to(cuda)
    for _ in range(2):
        eng.multiply("m", x)
    entry = eng.registry.get("m")
    eng.drain_tuning(timeout=120)
    assert isinstance(entry.last_x_ready, torch.cuda.Event)
    assert entry.last_x.device.type == "cuda"
    assert entry.last_x.data_ptr() != x.data_ptr()
    assert torch.equal(entry.last_x, x)
    [event] = eng.tune_events
    assert "error" not in event and event["candidates"] == event["planned"] >= 2
    np.testing.assert_array_equal(eng.multiply("m", x),
                                  a.numpy() @ x.cpu().numpy())


def _regular_triplets(rng, n: int, k: int = 16):
    """chip_smoke.py's regular recipe: k banded, jittered columns per row,
    values in {-2, -1, 1, 2}."""
    band = n // 16
    width = 2 * band // k
    offs = -band + np.arange(k) * width + rng.integers(0, width, (n, k))
    cols = ((np.arange(n)[:, None] + offs) % n).reshape(-1)
    vals = rng.choice(np.array([-2, -1, 1, 2], np.float32), n * k)
    return np.repeat(np.arange(n), k), cols, vals


def test_cluster_workers_on_the_card(cuda):
    """Two engine workers, each its own process and CUDA context on the
    card, at 65,536^2: answers at B=1 and B=8 bit-equal to torch's sparse
    product on the host, every multiply a kernel launch in the worker that
    served it, and a SIGKILLed worker's card memory given back."""
    import time

    from repro_torch.cluster import ClusterRouter

    n = 1 << 16
    rng = np.random.default_rng(12)
    ri, ci, vals = _regular_triplets(rng, n)
    sm = SparseMatrix.from_parts(ri, ci, vals, (n, n))
    host = torch.sparse_coo_tensor(torch.from_numpy(np.stack([ri, ci])),
                                   torch.from_numpy(vals), (n, n)).coalesce()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    router = ClusterRouter(workers=2, connect_timeout=120)
    try:
        info = router.register("reg", sm, replicas=2)
        assert sorted(info["placements"]) == ["w0", "w1"] and info["impl"] == "cuda"
        free1 = torch.cuda.mem_get_info()[0]
        before = router.stats()["workers"]
        for batch in (1, 1, 8, 8):
            x = _x(rng, n, None if batch == 1 else batch, torch.float32)
            want = torch.sparse.mm(host, x.reshape(n, -1)).reshape(x.shape)
            np.testing.assert_array_equal(router.multiply("reg", x.numpy()),
                                          want.numpy())
        after = router.stats()["workers"]
        for w, st in after.items():
            served = st["served"] - before[w]["served"]
            launched = sum(st["launches"].get(k, 0) - before[w]["launches"].get(k, 0)
                           for k in ("coo", "bcoo"))
            assert served == launched == 2, (w, served, launched)
        router.kill_worker("w0")
        deadline = time.monotonic() + 10
        while (torch.cuda.mem_get_info()[0] < free1 + (free0 - free1) / 4
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert torch.cuda.mem_get_info()[0] >= free1 + (free0 - free1) / 4
        for _ in range(2):  # round robin: one of the two finds w0 dead
            x = _x(rng, n, None, torch.float32)
            np.testing.assert_array_equal(
                router.multiply("reg", x.numpy()),
                torch.sparse.mm(host, x[:, None])[:, 0].numpy())
        assert [f["worker_id"] for f in router.failovers] == ["w0"]
        assert router.entries["reg"].placements == ["w1"]
    finally:
        router.close()


# ------------------------------------------------------------- topology


def test_detect_topology_on_card(cuda):
    from repro_torch.topo import detect_topology
    from repro_torch.topo.topology import HOST_LINK

    here = detect_topology()
    assert (here.name, here.axis_sizes, here.links) == ("cuda:flat", (1,),
                                                        (HOST_LINK,))
    assert torch.device(here.flat_devices()[0]) == torch.device(
        "cuda", torch.cuda.current_device())


@pytest.mark.parametrize("fmt", ["coo", "csr", "bcoo", "bcsr"])
def test_every_assignment_on_card_answers_alike(cuda, fmt):
    """Each assignment of pim2x2 on the (2, 2) grid: its slots, one
    part-axis launch per request, answers bit-equal to the single-device
    kernel and across assignments."""
    from repro_torch.topo import CollectiveCostModel, FakeTopology

    rng = np.random.default_rng(19)
    a = _matrix(rng, 256, 512, 0.1, torch.float32).numpy()
    sm = SparseMatrix.from_dense(a)
    topo = FakeTopology.pim_like((2, 2), devices=["cuda"] * 4)
    base = sm.plan(scheme="2d", fmt=fmt, grid=(2, 2), topology=topo)
    ranked = CollectiveCostModel(topo).rank(base.scheme, sm.shape, 4, base.axes)
    assert len(ranked) == 2
    single = sm.plan(fmt=fmt, device=cuda).compile()
    xs = [_x(rng, 512, b, torch.float32).numpy() for b in (None, 8)]
    ys = []
    for assignment, _ in ranked:
        exe = sm.plan(scheme="2d", fmt=fmt, grid=(2, 2), topology=topo,
                      assignment=assignment).compile()
        want_slots = FakeTopology.pim_like((2, 2)).device_order(
            assignment, devices=range(4))
        assert exe.mesh.slots.reshape(-1).tolist() == want_slots
        wants = [single(x) if x.ndim == 1 else single.batch(x) for x in xs]
        kind = "coo" if fmt in ("coo", "csr") else "bcoo"
        instrument.reset()
        got = [exe(x) if x.ndim == 1 else exe.batch(x) for x in xs]
        assert instrument.launches(kind) == len(xs)
        for g, w in zip(got, wants):
            np.testing.assert_array_equal(g, w)
        ys.append(got)
    for u, v in zip(*ys):
        np.testing.assert_array_equal(u, v)


def test_tune_under_a_topology_on_card(cuda):
    """One candidate per assignment on the card; a second tune is a cache
    hit that launches nothing and keeps card memory to the byte."""
    from repro_torch.topo import FakeTopology
    from repro_torch.tune import Measurer, Tuner

    rng = np.random.default_rng(23)
    a = _matrix(rng, 256, 512, 0.1, torch.float32).numpy()
    sm = SparseMatrix.from_dense(a)
    topo = FakeTopology.pim_like((2, 2), devices=["cuda"] * 4)
    tuner = Tuner(measurer=Measurer(warmup=1, iters=2))
    first = tuner.tune(sm, topology=topo)
    assert first.key.topology == "cuda:4|pim2x2:2x2"
    ids = [m.scheme_id for m in first.measurements]
    assert sum("@" in i for i in ids) >= 2
    exe = first.best.compile()
    x = _x(rng, 512, None, torch.float32).numpy()
    np.testing.assert_array_equal(exe(x), sm.plan(device=cuda).compile()(x))
    gc.collect()
    torch.cuda.synchronize()
    mem0, n0 = torch.cuda.memory_allocated(), instrument.launches()
    again = tuner.tune(sm, topology=topo)
    assert again.from_cache and not again.measurements
    assert again.best.scheme_id == first.best.scheme_id
    gc.collect()
    torch.cuda.synchronize()
    assert instrument.launches() == n0 and torch.cuda.memory_allocated() == mem0
