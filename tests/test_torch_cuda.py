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
import numpy as np
import pytest
import torch

from repro_torch.api import SparseMatrix
from repro_torch.core import formats as F
from repro_torch.kernels import instrument, ops
from repro_torch.kernels.bcsr_spmv import (bcoo_spmv, bcoo_spmv_cuda,
                                           bcoo_spmv_plain, block_row_ptr)
from repro_torch.kernels.coo_spmv import coo_spmv, coo_spmv_plain, plan_chunks

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
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("block", [(8, 16), (4, 8), (8, 128)])
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
