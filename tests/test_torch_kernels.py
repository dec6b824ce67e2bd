"""repro_torch.kernels against repro.kernels on the CPU.

Chunk plans must equal the JAX package's array for array; the kernels'
plain versions must equal the Pallas kernels run in interpret mode on the
same plan (exactly on integer-valued inputs and integer dtypes, at
rtol=atol=2e-4 on random float32 — tests/test_kernels.py's tolerance — and
in the same output dtype); the torch oracles must equal repro.kernels.ref.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bcsr_spmv import bcoo_spmv_pallas
from repro.kernels.coo_spmv import coo_spmv_pallas
from repro.kernels.coo_spmv import plan_chunks as j_plan_chunks
from repro.kernels.csr_spmv import csr_plan_chunks as j_csr_plan_chunks
from repro.kernels.ell_spmv import dense_to_ell as j_dense_to_ell
from repro.kernels.ell_spmv import ell_spmv_pallas
from repro.core import formats as JF
from repro_torch import convert
from repro_torch.core import formats as TF
from repro_torch.kernels import instrument, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bcsr_spmv import (bcoo_spmv, bcoo_spmv_plain, block_route,
                                           block_row_ptr, route_takes)
from repro_torch.core import distributed as D
from repro_torch.core.mesh import make_mesh
from repro_torch.core.partition import partition_1d
from repro_torch.kernels import coo_spmv as coo_mod
from repro_torch.kernels.coo_spmv import (ChunkPlan, coo_spmv, coo_spmv_plain,
                                          plan_chunks, plan_pieces,
                                          stack_chunk_plans)
from repro_torch.kernels.csr_spmv import csr_plan_chunks, csr_spmv
from repro_torch.kernels.ell_spmv import (_pack_ell, dense_to_ell, ell_spmv,
                                          ell_spmv_plain)

from _torch_common import (BF16, as_f32, assert_same_fields, jax_fields, np_of,
                           rand_sparse)

SHAPES = [(16, 32), (64, 96), (130, 70), (256, 512)]  # tests/test_kernels.py


def _x(n, batch, dtype, seed, integer=True):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (n, batch)
    vals = rng.integers(-2, 3, shape) if integer else rng.standard_normal(shape)
    return vals.astype(dtype)


def _compare(got: torch.Tensor, want, exact: bool):
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert tuple(got.shape) == want.shape
    if exact:
        np.testing.assert_array_equal(as_f32(got) if got.is_floating_point()
                                      else got.numpy(), want.astype(
                                          np.float32 if got.is_floating_point()
                                          else want.dtype))
    else:
        np.testing.assert_allclose(as_f32(got), want.astype(np.float32),
                                   rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------- planners


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("row_granular", [False, True])
def test_plan_chunks_match_jax(shape, row_granular):
    m, n = shape
    a = rand_sparse(m, n, 0.08, np.float32, seed=m + n)
    a[m // 2] = 1.0  # a row longer than one chunk
    ri, ci = np.nonzero(a)
    want = j_plan_chunks(ri, ci, a[ri, ci], m, chunk=64, span=64,
                         row_granular=row_granular)
    got = plan_chunks(ri, ci, a[ri, ci], m, chunk=64, span=64,
                      row_granular=row_granular)
    assert_same_fields(got, want)
    assert got.window_start.tolist() == np.searchsorted(
        np.asarray(want.window), np.arange(want.n_windows + 1)).tolist()


@pytest.mark.parametrize("shape", SHAPES)
def test_csr_plan_chunks_match_jax(shape):
    m, n = shape
    a = rand_sparse(m, n, 0.08, np.int32, seed=2 * m + n)
    jc = JF.dense_to_csr(a)
    want = j_csr_plan_chunks(np.asarray(jc.rowptr), np.asarray(jc.colind),
                             np.asarray(jc.values), m, chunk=64, span=64)
    tc = TF.dense_to_csr(a)
    got = csr_plan_chunks(tc.rowptr, tc.colind, tc.values, m, chunk=64, span=64)
    assert_same_fields(got, want)


def test_dense_row_pathology_plan_matches_jax():
    """Paper Obs. 4: one very dense row splits into many chunks."""
    a = np.zeros((64, 128), np.float32)
    a[7] = np.arange(1, 129)
    a[20, 3] = 1.0
    ri, ci = np.nonzero(a)
    want = j_plan_chunks(ri, ci, a[ri, ci], 64, chunk=32, span=64)
    got = plan_chunks(ri, ci, a[ri, ci], 64, chunk=32, span=64)
    assert got.n_chunks >= 4
    assert_same_fields(got, want)


# ------------------------------------------------------------ piece table


def _check_pieces(pieces, splits, window_start, M):
    """Every chunk of [0, window_start[-1]) in exactly one piece; each
    window's pieces contiguous, in chunk order, at most M chunks, one for
    an empty window; slots numbered in piece order; padding rows last."""
    pc, sp, ws = pieces.numpy(), splits.numpy(), window_start.numpy()
    real = pc[pc[:, 0] >= 0]
    assert (pc[len(real):, 0] == -1).all()  # padding only after the pieces
    covered = np.zeros(ws[-1], int)
    for lo, hi in real[:, 1:3]:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert (real[:, 2] - real[:, 1] <= M).all()
    for w in range(len(ws) - 1):
        mine = real[real[:, 0] == w]
        n = ws[w + 1] - ws[w]
        assert len(mine) == max(1, -(-n // M)), (w, n)
        assert mine[0, 1] == ws[w] and mine[-1, 2] == ws[w + 1]
        assert (mine[1:, 1] == mine[:-1, 2]).all()  # contiguous, in order
        if len(mine) == 1:
            assert mine[0, 3] == -1
        else:
            slots = mine[:, 3]
            assert (np.diff(slots) == 1).all()
            for z in slots:
                assert sp[z].tolist() == [w, slots[0], slots[-1] + 1]
    n_slots = int((real[:, 3] >= 0).sum())
    assert (real[real[:, 3] >= 0, 3] == np.arange(n_slots)).all()
    assert (sp[n_slots:, 0] == -1).all()


@pytest.mark.parametrize("M", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("row_granular", [False, True])
def test_pieces_cover_every_chunk_once(M, row_granular):
    a = rand_sparse(300, 200, 0.1, np.float32, seed=51, integer=True)
    a[17] = 1.0  # a row over several chunks
    a[150:210] = 0  # an empty window
    ri, ci = np.nonzero(a)
    plan = plan_chunks(ri, ci, a[ri, ci], 300, chunk=16, span=64,
                       row_granular=row_granular)
    pieces, splits = plan_pieces(plan.window_start, M)
    assert pieces.dtype == splits.dtype == torch.int32
    _check_pieces(pieces, splits, plan.window_start, M)
    if M == coo_mod.PIECE_CHUNKS:  # the plan carries the default table
        assert torch.equal(plan.pieces, pieces) and torch.equal(plan.splits, splits)


@pytest.mark.parametrize("M", [3, 8, 32])
def test_window_of_M_chunks_is_one_piece_and_M_plus_1_two(M):
    ws = torch.tensor([0, M, 2 * M + 1, 2 * M + 1, 2 * M + 1 + 3 * M + 2],
                      dtype=torch.int32)
    pieces, splits = plan_pieces(ws, M)
    _check_pieces(pieces, splits, ws, M)
    per_window = np.bincount(pieces[:, 0].numpy(), minlength=4).tolist()
    assert per_window == [1, 2, 1, 4]  # M, M + 1, empty, 3M + 2 chunks
    half = (M + 1) // 2
    assert pieces[1:3, 2].sub(pieces[1:3, 1]).tolist() == [half, M + 1 - half]
    assert splits.shape == (6, 3)  # one row per slot of the split windows


def test_stacked_pieces_carry_part_and_skip_padding_chunks():
    a = rand_sparse(96, 128, 0.12, np.float32, seed=52, integer=True)
    a[21] = 1.0  # split by 1d.nnz
    part = partition_1d(a, 4, "coo", "rows")
    arrs = D.kernel_chunk_arrays(part, chunk=16)
    ws, count = arrs["chunk_window_start"], arrs["chunk_count"]
    pieces, splits = arrs["chunk_pieces"], arrs["chunk_splits"]
    assert pieces.shape[0] == splits.shape[0] == 4  # the part axis leads
    assert pieces.shape[-1] == 4 and splits.shape[-1] == 3
    n_real = (count > 0).sum(1)
    assert (n_real < count.shape[1]).any()  # some part carries padding chunks
    for p in range(4):
        _check_pieces(pieces[p], splits[p], ws[p], coo_mod.PIECE_CHUNKS)
        real = pieces[p][pieces[p, :, 0] >= 0]
        assert int(real[:, 2].max()) == int(n_real[p])  # padding in no piece
    small = stack_chunk_plans([plan_chunks(*np.nonzero(b), b[np.nonzero(b)], 96,
                                           chunk=8, span=32)
                               for b in (a[:48], a[48:])])
    for p in range(2):
        want = plan_pieces(small["window_start"][p])
        assert torch.equal(small["pieces"][p][: len(want[0])], want[0])
    assert ChunkPlan(**small).part(1).pieces.shape == small["pieces"].shape[1:]


def test_local_kernel_is_given_the_piece_table(monkeypatch):
    """The table is built once, at placement: a request through the local
    kernel carries it in from the placed arrays and builds none."""
    a = rand_sparse(96, 128, 0.12, np.float32, seed=53, integer=True)
    a[21] = 2.0
    sm_part = partition_1d(a, 4, "coo", "nnz")
    arrs = D.place_1d(sm_part, make_mesh((4,), ("parts",), ["cpu"] * 4),
                      extra=D.kernel_chunk_arrays(sm_part, chunk=16))
    local = D.LocalKernel(sm_part, "cuda")
    x = TF.to_tensor(_x(128, 3, np.float32, seed=54))
    want = local.plain(arrs, x)

    def boom(*args, **kw):
        raise AssertionError("the piece table was rebuilt")

    monkeypatch.setattr(coo_mod, "plan_pieces", boom)
    plan = local._plan(arrs)
    assert plan.pieces is arrs["chunk_pieces"] and plan.splits is arrs["chunk_splits"]
    assert torch.equal(local.raw(arrs, x), want)
    assert torch.equal(local(arrs, x), want.to(sm_part.dtype))


def _emulate_pieces(plan: ChunkPlan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's two passes in plain torch: the plain version over each
    piece's chunks alone (pass 1), then each split window's partial tiles
    summed in piece order (pass 2); single pieces write their tile."""
    span, y = plan.span, None
    partial = {}
    for w, lo, hi, slot in plan.pieces.tolist():
        if w < 0:
            continue
        sub = ChunkPlan(plan.rowind[lo:hi], plan.colind[lo:hi], plan.values[lo:hi],
                        plan.window[lo:hi], plan.count[lo:hi], plan.n_windows,
                        plan.out_rows, span)
        tile = coo_spmv_plain(sub, x)
        if y is None:
            y = torch.zeros_like(tile)
        rows = slice(w * span, (w + 1) * span)
        if slot < 0:
            y[rows] = tile[rows]
        else:
            partial[slot] = tile[rows]
    for z, (w, lo, hi) in enumerate(plan.splits.tolist()):
        if w >= 0 and z == lo:  # the slot that opens its window
            acc = partial[lo]
            for z in range(lo + 1, hi):
                acc = acc + partial[z]
            y[w * span: (w + 1) * span] = acc
    return y


@pytest.mark.parametrize("M", [1, 3, 32])
@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("batch", [None, 4])
def test_piece_emulation_equals_the_whole_plan(M, dtype, batch):
    a = rand_sparse(300, 200, 0.1, np.float32, seed=55, integer=True).astype(dtype)
    a[70] = 1  # a row over several chunks and pieces
    ri, ci = np.nonzero(a)
    plan = plan_chunks(ri, ci, TF.to_tensor(a[ri, ci]), 300, chunk=16, span=64)
    pieces, splits = plan_pieces(plan.window_start, M)
    plan = dataclasses.replace(plan, pieces=pieces, splits=splits)
    assert plan.splits.shape[0] > 0 or M == 32  # row 70's window is split
    x = TF.to_tensor(_x(200, batch, dtype, seed=56))
    assert torch.equal(_emulate_pieces(plan, x), coo_spmv_plain(plan, x))


@pytest.mark.parametrize("row_granular", [False, True], ids=["coo", "csr"])
def test_piece_emulation_matches_pallas_on_a_heavy_window(row_granular):
    """2,048 x 65,536 with one row of 40,000 nonzeros: its window is split
    into pieces; the two passes equal the JAX kernel in interpret mode."""
    rng = np.random.default_rng(57)
    m, n = 2048, 65536
    rows = np.concatenate([np.repeat(np.arange(m), 6), np.full(40000, 700)])
    cols = np.concatenate([rng.integers(0, n, m * 6),
                           np.sort(rng.choice(n, 40000, replace=False))])
    key = np.unique(rows * n + cols)
    ri, ci = key // n, key % n
    vals = rng.choice(np.array([-2, -1, 1, 2], np.float32), len(ri))
    x = rng.integers(-2, 3, n).astype(np.float32)
    jplan = j_plan_chunks(ri, ci, vals, m, row_granular=row_granular)
    want = coo_spmv_pallas(jplan, jnp.asarray(x), interpret=True)
    plan = plan_chunks(ri, ci, vals, m, row_granular=row_granular)
    assert_same_fields(plan, jplan)
    n_split = int((plan.splits[:, 0] >= 0).sum())
    assert n_split >= 40000 // (512 * 32)  # the heavy window is split
    got = _emulate_pieces(plan, TF.to_tensor(x))
    _compare(got, want, exact=True)
    assert torch.equal(got, coo_spmv_plain(plan, TF.to_tensor(x)))


# ------------------------------------------------- plain versions vs Pallas


COO_CASES = [  # (shape, dtype, integer-valued, batch)
    ((16, 32), np.int32, True, None),
    ((64, 96), np.int32, True, None),
    ((130, 70), np.int32, True, None),
    ((256, 512), np.int32, True, None),
    ((130, 70), np.float32, True, None),
    ((130, 70), np.float32, False, None),
    ((256, 512), np.float32, False, None),
    ((130, 70), np.int8, True, None),
    ((130, 70), BF16, True, None),
    ((130, 70), np.float32, True, 3),
    ((64, 96), BF16, True, 8),
]


@pytest.mark.parametrize("shape,dtype,integer,batch", COO_CASES)
def test_coo_plain_matches_pallas(shape, dtype, integer, batch):
    m, n = shape
    a = rand_sparse(m, n, 0.08, np.float32, seed=m + n, integer=integer)
    a[m // 3] = rand_sparse(1, n, 1.0, np.float32, seed=9, integer=True)[0]
    a = a.astype(dtype)
    x = _x(n, batch, dtype, seed=n, integer=integer)
    ri, ci = np.nonzero(a)
    jplan = j_plan_chunks(ri, ci, a[ri, ci], m, chunk=64, span=64)
    want = coo_spmv_pallas(jplan, jnp.asarray(x))
    plan = convert.chunk_plan(jax_fields(jplan))
    got = coo_spmv_plain(plan, TF.to_tensor(x))
    exact = integer or np.issubdtype(np.dtype(dtype), np.integer)
    _compare(got, want, exact)
    # the dispatcher takes the plain version for a CPU tensor; csr_spmv too
    assert torch.equal(coo_spmv(plan, TF.to_tensor(x)), got)
    assert torch.equal(csr_spmv(plan, TF.to_tensor(x)), got)


BCOO_CASES = [  # (block, dtype, integer-valued, batch)
    ((8, 16), np.float32, True, None),
    ((8, 16), np.float32, False, None),
    ((8, 16), np.float32, False, 3),
    ((8, 16), BF16, True, None),
    ((8, 16), np.int8, True, 4),
    ((8, 16), np.int32, True, None),
    ((4, 8), np.int8, True, None),
    ((8, 128), np.float32, True, 3),
]


@pytest.mark.parametrize("block,dtype,integer,batch", BCOO_CASES)
def test_bcoo_plain_matches_pallas(block, dtype, integer, batch):
    r, c = block
    m, n = r * 10, c * 6 - 3  # x is zero-padded up to a multiple of c
    a = rand_sparse(m, c * 6, 0.15, np.float32, seed=r * c, integer=integer)
    a[:, n:] = 0
    a[r:2 * r] = 0  # an empty block-row is written as zeros
    a = a.astype(dtype)
    x = _x(n, batch, dtype, seed=5, integer=integer)
    jm = JF.dense_to_bcoo(a, block=block, capacity=80)
    want = bcoo_spmv_pallas(jm.browind, jm.bcolind, jm.bvalues, jnp.asarray(x),
                            m, jm.nblocks)
    tm = TF.dense_to_bcoo(a, block=block, capacity=80)
    got = bcoo_spmv_plain(tm.browind, tm.bcolind, tm.bvalues, TF.to_tensor(x),
                          m, tm.nblocks)
    exact = integer or np.issubdtype(np.dtype(dtype), np.integer)
    _compare(got, want, exact)
    assert torch.equal(bcoo_spmv(tm.browind, tm.bcolind, tm.bvalues,
                                 TF.to_tensor(x), m, tm.nblocks), got)


ROUTE_CASES = [  # (dtype, block, B, the block kernel's route)
    (torch.float32, (8, 16), 1, "warp"),
    (torch.float32, (8, 16), 8, "mma"),
    (torch.float32, (8, 16), 64, "mma"),
    (torch.float32, (8, 16), 3, "rows"),
    (torch.float32, (4, 8), 1, "warp"),
    (torch.float32, (4, 8), 64, "rows"),
    (torch.float32, (8, 128), 1, "rows"),
    (torch.float32, (8, 128), 64, "mma"),
    (torch.float32, (16, 16), 1, "rows"),
    (torch.float32, (16, 16), 40, "mma"),
    (torch.bfloat16, (8, 16), 1, "warp"),
    (torch.bfloat16, (8, 16), 64, "mma"),
    (torch.float16, (8, 16), 8, "mma"),
    (torch.bfloat16, (8, 8), 64, "rows"),
    (torch.float32, (8, 12), 64, "rows"),
    (torch.int8, (8, 16), 1, "warp"),
    (torch.int8, (8, 16), 8, "rows"),
    (torch.int16, (8, 16), 1, "warp"),
    (torch.int16, (8, 16), 64, "rows"),
    (torch.int32, (8, 16), 1, "warp"),
    (torch.int32, (8, 16), 64, "rows"),
    (torch.int8, (4, 8), 64, "rows"),
]


@pytest.mark.parametrize("dtype,block,B,route", ROUTE_CASES,
                         ids=lambda v: str(v).removeprefix("torch."))
def test_block_route_choice(dtype, block, B, route):
    assert block_route(dtype, *block, B) == route
    assert route_takes(route, dtype, *block, B)
    # the CUDA-core route takes every shape; integer values never the mma
    assert route_takes("rows", dtype, *block, B)
    assert not (route_takes("mma", dtype, *block, B)
                and not dtype.is_floating_point)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, ties away from zero), as
    the kernel's cvt.rna.tf32.f32, on the int32 view."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_bcoo(m, x, passes: int = 3) -> torch.Tensor:
    """The tensor-core route's f32 arithmetic in plain torch: a = a_hi + a_lo
    and x = x_hi + x_lo in TF32, and the products a_lo x_hi + a_hi x_lo +
    a_hi x_hi summed in float32 (``passes=1``: a_hi x_hi alone)."""
    def run(v, xx):
        return bcoo_spmv_plain(m.browind, m.bcolind, v, xx, m.rows, m.nblocks)

    ah, xh = _tf32(m.bvalues), _tf32(x)
    if passes == 1:
        return run(ah, xh)
    al, xl = _tf32(m.bvalues - ah), _tf32(x - xh)
    return run(al, xh) + run(ah, xl) + run(ah, xh)


def _dense_blocks(integer: bool):
    a = rand_sparse(8 * 12, 16 * 8, 0.6, np.float32, seed=31, integer=integer)
    a[8:16] = 0
    return a, TF.dense_to_bcoo(a, block=(8, 16), capacity=96)


@pytest.mark.parametrize("batch", [None, 8, 40])
def test_3xtf32_is_exact_on_integer_values(batch):
    _, m = _dense_blocks(integer=True)
    x = TF.to_tensor(_x(m.cols, batch, np.float32, seed=32))
    assert torch.equal(_tf32(m.bvalues), m.bvalues)
    assert torch.equal(_tf32_bcoo(m, x), bcoo_spmv_plain(
        m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks))


@pytest.mark.parametrize("batch", [8, 40])
def test_3xtf32_holds_the_tolerance_and_one_pass_does_not(batch):
    """Random float32: three TF32 passes stay within 2e-4 of the Pallas
    kernel and of the plain version; one pass (10 mantissa bits) misses it,
    which is why the tensor-core route takes three."""
    a, m = _dense_blocks(integer=False)
    xn = _x(m.cols, batch, np.float32, seed=33, integer=False)
    x = TF.to_tensor(xn)
    jm = JF.dense_to_bcoo(a, block=(8, 16), capacity=96)
    pallas = np.asarray(bcoo_spmv_pallas(jm.browind, jm.bcolind, jm.bvalues,
                                         jnp.asarray(xn), m.rows, jm.nblocks))
    plain = bcoo_spmv_plain(m.browind, m.bcolind, m.bvalues, x, m.rows, m.nblocks)
    three = _tf32_bcoo(m, x)
    _compare(three, pallas, exact=False)
    torch.testing.assert_close(three, plain, rtol=2e-4, atol=2e-4)
    one = _tf32_bcoo(m, x, passes=1)
    assert not torch.allclose(one, plain, rtol=2e-4, atol=2e-4)


def test_block_row_ptr_matches_bcsr():
    a = rand_sparse(80, 96, 0.1, np.float32, seed=12)
    a[8:24] = 0
    bcoo = TF.dense_to_bcoo(a, block=(8, 16), capacity=60)
    bcsr = TF.dense_to_bcsr(a, block=(8, 16), capacity=60)
    assert torch.equal(block_row_ptr(bcoo.browind, bcoo.nblocks, 10), bcsr.browptr)


def test_wrappers_raise_on_non_cpu_non_cuda_tensors():
    """A wrapper runs the plain version only for a CPU tensor; any other
    device goes to the kernel, which refuses what is not on a CUDA device."""
    a = rand_sparse(32, 48, 0.2, np.float32, seed=13)
    ri, ci = np.nonzero(a)
    plan = plan_chunks(ri, ci, a[ri, ci], 32)
    with pytest.raises(ValueError, match="CUDA"):
        coo_spmv(plan, torch.zeros(48, device="meta"))
    m = TF.dense_to_bcoo(a, block=(8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        bcoo_spmv(m.browind, m.bcolind, m.bvalues, torch.zeros(48, device="meta"),
                  32, m.nblocks, browptr=block_row_ptr(m.browind, m.nblocks, 4))


# ------------------------------------------------------------------- ELL


@pytest.mark.parametrize("k_pad", [None, 3, 17])  # tests/test_kernels.py:88
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int8, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_dense_to_ell_matches_jax(k_pad, dtype):
    a = rand_sparse(90, 64, 0.1, np.float32, seed=11, integer=True)
    a[4] = 0  # an empty row
    a = a.astype(dtype)
    want = j_dense_to_ell(a, k=k_pad)
    got = dense_to_ell(a, k=k_pad)
    for g, w, name in zip(got, want, ("colind", "values", "row_nnz")):
        assert isinstance(g, torch.Tensor), name
        assert np_of(g).dtype == np_of(w).dtype, name
        np.testing.assert_array_equal(np_of(g), np_of(w), err_msg=name)
    ri, ci = np.nonzero(a)  # the packer the dense door uses never densifies
    for g, t in zip(got, _pack_ell(ri, ci, TF.to_tensor(a[ri, ci]), 90, k_pad)):
        assert torch.equal(g, t)


ELL_CASES = [  # (k_pad, dtype, integer-valued, batch, batch_tile)
    (None, np.float32, False, None, None),  # tests/test_kernels.py:88-97
    (3, np.float32, False, None, None),  # rows truncated to 3 slots
    (17, np.float32, False, None, None),  # padded past every row
    (None, np.float32, False, 5, 2),  # tests/test_kernels.py:161-170
    (None, np.float32, True, 5, None),
    (3, np.int8, True, None, None),
    (17, BF16, True, 4, None),
    (None, np.int32, True, 3, 1),
]


@pytest.mark.parametrize("k_pad,dtype,integer,batch,bt", ELL_CASES)
def test_ell_plain_matches_pallas_and_ref(k_pad, dtype, integer, batch, bt):
    a = rand_sparse(90, 64, 0.1, np.float32, seed=11, integer=integer)
    a = a.astype(dtype)
    ci, vv, rn = j_dense_to_ell(a, k=k_pad)
    x = _x(64, batch, dtype, seed=12, integer=integer)
    exact = integer or np.issubdtype(np.dtype(dtype), np.integer)
    want = ell_spmv_pallas(jnp.asarray(ci), jnp.asarray(vv), jnp.asarray(rn),
                           jnp.asarray(x), batch_tile=bt)
    tci, tvv, trn = (TF.to_tensor(t) for t in (ci, vv, rn))
    got = ell_spmv_plain(tci, tvv, trn, TF.to_tensor(x))
    _compare(got, want, exact)  # the accumulation dtype, as the Pallas kernel
    assert torch.equal(ell_spmv(tci, tvv, trn, TF.to_tensor(x), bt), got)
    jwant = jref.ell_spmv_ref(jnp.asarray(ci), jnp.asarray(vv), jnp.asarray(x),
                              jnp.asarray(rn))
    tgot = tref.ell_spmv_ref(tci, tvv, TF.to_tensor(x), trn)
    _compare(tgot, jwant, exact)
    assert tgot.dtype == tvv.dtype  # the oracle casts back, the kernel does not


def test_ell_masked_and_clipped_slots_match_jax():
    """Slots at or past row_nnz add nothing, even with nonzero values, and
    out-of-range columns clip to the edge of x (take(mode="clip"))."""
    rng = np.random.default_rng(13)
    ci = rng.integers(-5, 80, (40, 6)).astype(np.int32)  # some outside [0, 64)
    vv = rng.integers(-3, 4, (40, 6)).astype(np.float32)
    rn = rng.integers(0, 8, 40).astype(np.int32)  # some beyond K = 6
    x = rng.integers(-2, 3, (64, 3)).astype(np.float32)
    want = ell_spmv_pallas(*(jnp.asarray(t) for t in (ci, vv, rn, x)))
    got = ell_spmv(*(TF.to_tensor(t) for t in (ci, vv, rn, x)))
    _compare(got, want, exact=True)
    jwant = jref.ell_spmv_ref(*(jnp.asarray(t) for t in (ci, vv, x[:, 0], rn)))
    _compare(tref.ell_spmv_ref(*(TF.to_tensor(t) for t in (ci, vv, x[:, 0], rn))),
             jwant, exact=True)


def test_ell_exported_like_the_jax_package():
    from repro_torch import kernels

    assert kernels.ell_spmv is ell_spmv and ops.ell_spmv is ell_spmv
    a = rand_sparse(16, 24, 0.2, np.float32, seed=14)
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv(*dense_to_ell(a), torch.zeros(24, device="meta"))


# ------------------------------------------------------ oracles vs ref.py


JREF = {
    "csr": lambda m, x: jref.csr_spmv_ref(m.rowptr, m.colind, m.values, x, m.rows),
    "coo": lambda m, x: jref.coo_spmv_ref(m.rowind, m.colind, m.values, x,
                                          m.rows, m.nnz),
    "bcsr": lambda m, x: jref.bcsr_spmv_ref(m.browptr, m.bcolind, m.bvalues, x,
                                            m.rows),
    "bcoo": lambda m, x: jref.bcoo_spmv_ref(m.browind, m.bcolind, m.bvalues, x,
                                            m.rows, m.nblocks),
}
MAKERS = {
    "csr": (JF.dense_to_csr, TF.dense_to_csr),
    "coo": (JF.dense_to_coo, TF.dense_to_coo),
    "bcsr": (lambda a: JF.dense_to_bcsr(a, (8, 16), 100),
             lambda a: TF.dense_to_bcsr(a, (8, 16), 100)),
    "bcoo": (lambda a: JF.dense_to_bcoo(a, (8, 16), 100),
             lambda a: TF.dense_to_bcoo(a, (8, 16), 100)),
}


@pytest.mark.parametrize("fmt", list(MAKERS))
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int8, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("batch", [None, 3])
def test_torch_oracles_match_jax_ref(fmt, dtype, batch):
    a = rand_sparse(64, 96, 0.1, np.float32, seed=21, integer=True).astype(dtype)
    x = _x(96, batch, dtype, seed=22)
    jm, tm = (make(a) for make in MAKERS[fmt])
    want = JREF[fmt](jm, jnp.asarray(x))
    got = ops.spmv(tm, TF.to_tensor(x), impl="torch")
    _compare(got, want, exact=True)  # integer-valued: every order is exact
    assert got.dtype == tm.dtype  # cast back to the values dtype


def test_torch_oracles_random_f32_within_tolerance():
    a = rand_sparse(64, 96, 0.1, np.float32, seed=23)
    X = _x(96, 5, np.float32, seed=24, integer=False)
    for fmt, (jmake, tmake) in MAKERS.items():
        want = JREF[fmt](jmake(a), jnp.asarray(X))
        _compare(ops.spmm(tmake(a), TF.to_tensor(X), impl="torch"), want, False)
    np.testing.assert_allclose(as_f32(tref.coo_spmv_ref(
        *[torch.from_numpy(t) for t in (np.nonzero(a)[0], np.nonzero(a)[1],
                                        a[np.nonzero(a)])],
        TF.to_tensor(X), 64)), a @ X, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("fmt", list(MAKERS))
def test_ops_cuda_impl_on_cpu_runs_the_plain_versions(fmt):
    a = rand_sparse(64, 96, 0.1, np.float32, seed=31, integer=True)
    m = MAKERS[fmt][1](a)
    X = TF.to_tensor(_x(96, 4, np.float32, seed=32))
    instrument.reset()
    y = ops.spmm(m, X, impl="cuda")
    assert torch.equal(y, ops.spmm(m, X, impl="torch"))
    assert torch.equal(ops.kernel_program(m)(X[:, 1]), y[:, 1])
    assert instrument.launches() == 0  # no kernel ran
    with pytest.raises(ValueError, match="cols, B"):
        ops.spmm(m, X[:, 0])
    with pytest.raises(ValueError, match="unknown impl"):
        ops.spmv(m, X, impl="pallas")


def test_instrument_counts_like_the_jax_counter():
    instrument.reset()
    instrument.record_launch("coo", 1)
    instrument.record_launch("coo", 8)
    instrument.record_launch("bcoo", 3)
    instrument.record_launch("ell", 1)
    assert instrument.launches("coo") == 2 and instrument.launches("coo.spmm") == 1
    assert instrument.launches("bcoo.spmm") == 1 and instrument.launches("ell") == 1
    assert instrument.launches() == 6  # every key, as repro's builds()
    instrument.reset()
    assert instrument.launches() == 0
