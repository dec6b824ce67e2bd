"""repro_torch's partitioners and per-part kernel plans against repro's.

``partition_1d`` / ``partition_2d`` for every balance or scheme, the four
formats and several dtypes must equal ``repro.core.partition`` array for
array (bfloat16 by its bits); the triplet partitioners the api uses must
equal the dense front door; ``stack_chunk_plans``, the per-part chunk plans
of the CUDA kernel (``kernel_chunk_arrays``, the JAX package's
``pallas_chunk_arrays``) and ``bucket_by_source_shard`` must equal theirs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import partition as JP
from repro.kernels.coo_spmv import plan_chunks as j_plan_chunks
from repro.kernels.coo_spmv import stack_chunk_plans as j_stack_chunk_plans
from repro_torch.api import SparseMatrix
from repro_torch.core import distributed as TD
from repro_torch.core import partition as TP
from repro_torch.kernels.coo_spmv import ChunkPlan, plan_chunks, stack_chunk_plans

from _torch_common import BF16, np_of, rand_sparse

FORMATS = ["coo", "csr", "bcoo", "bcsr"]
BLOCK = (8, 16)


def _matrix(dtype=np.float32, seed=1):
    a = rand_sparse(64, 96, 0.1, np.float32, seed=seed, integer=True)
    a[5] = 3.0  # a dense row: element-granular parts split it
    a[40:48] = 0  # an empty block-row
    return a.astype(dtype)


def assert_same_partition(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            gn, wn = np_of(g), np_of(w)
            assert gn.dtype == wn.dtype, (f.name, gn.dtype, wn.dtype)
            np.testing.assert_array_equal(gn, wn, err_msg=f.name)
        else:
            assert (tuple(g) if isinstance(g, tuple) else g) == \
                (tuple(w) if isinstance(w, tuple) else w), f.name
    assert got.padding_efficiency == pytest.approx(want.padding_efficiency)


ONE_D = [(fmt, bal) for fmt in FORMATS for bal in TP.BALANCE_1D
         if not (bal == "nnz" and fmt in ("csr", "bcsr"))]


@pytest.mark.parametrize("fmt,balance", ONE_D)
@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int8],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("parts", [3, 4])
def test_partition_1d_matches_jax(fmt, balance, dtype, parts):
    a = _matrix(dtype)
    assert_same_partition(TP.partition_1d(a, parts, fmt, balance, BLOCK),
                          JP.partition_1d(a, parts, fmt, balance, BLOCK))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scheme", TP.SCHEMES_2D)
@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 3), (2, 3)])
def test_partition_2d_matches_jax(fmt, scheme, grid):
    a = _matrix(np.float32, seed=2)
    assert_same_partition(TP.partition_2d(a, grid, fmt, scheme, BLOCK),
                          JP.partition_2d(a, grid, fmt, scheme, BLOCK))


@pytest.mark.parametrize("dtype", [BF16, np.int8], ids=lambda d: np.dtype(d).name)
def test_partition_2d_low_precision_matches_jax(dtype):
    a = _matrix(dtype, seed=3)
    for fmt in FORMATS:
        for scheme in TP.SCHEMES_2D:
            assert_same_partition(TP.partition_2d(a, (2, 2), fmt, scheme, BLOCK),
                                  JP.partition_2d(a, (2, 2), fmt, scheme, BLOCK))


def test_partition_errors_match_jax():
    a = _matrix()
    for fmt in ("csr", "bcsr"):
        with pytest.raises(ValueError, match="row-granular"):
            TP.partition_1d(a, 4, fmt, "nnz", BLOCK)
    with pytest.raises(ValueError, match="balance"):
        TP.partition_1d(a, 4, "coo", "cols")
    with pytest.raises(ValueError, match="scheme"):
        TP.partition_2d(a, (2, 2), "coo", "square")
    with pytest.raises(ValueError, match="fmt"):
        TP.partition_2d(a, (2, 2), "ell")


@pytest.mark.parametrize("fmt", FORMATS)
def test_triplet_partition_equals_the_dense_front_door(fmt):
    """The api partitions a matrix's coalesced triplets, never the dense
    matrix; duplicates summed and zeros dropped, the arrays are the same."""
    a = _matrix(np.float32, seed=4)
    ri, ci = np.nonzero(a)
    dup = np.arange(0, len(ri), 7)  # split some entries into two halves
    rows = np.concatenate([ri, ri[dup]])
    cols = np.concatenate([ci, ci[dup]])
    vals = np.concatenate([a[ri, ci], a[ri[dup], ci[dup]] * 0])  # + explicit 0s
    sm = SparseMatrix.from_parts(rows, cols, vals, a.shape)
    tri = sm.triplets()
    for balance in ("rows", "nnz-rgrn"):
        assert_same_partition(
            TP.partition_1d_coalesced(*tri, a.shape, 4, fmt, balance, BLOCK),
            JP.partition_1d(a, 4, fmt, balance, BLOCK))
    for scheme in TP.SCHEMES_2D:
        assert_same_partition(
            TP.partition_2d_coalesced(*tri, a.shape, (2, 2), fmt, scheme, BLOCK),
            JP.partition_2d(a, (2, 2), fmt, scheme, BLOCK))
    assert sm._dense is None
    # a plan partitions the triplets in the plan's dtype
    pln = sm.plan(scheme="2d.variable-sized", fmt=fmt, devices=["cpu"] * 4,
                  block=BLOCK)
    assert_same_partition(pln._partition(), JP.partition_2d(
        a, pln.grid, fmt, "variable-sized", BLOCK))
    assert sm._dense is None


def test_stack_chunk_plans_matches_jax():
    rng = np.random.default_rng(5)
    plans, jplans = [], []
    for p, n in enumerate([300, 0, 41, 180]):  # an empty part too
        ri = np.sort(rng.integers(0, 40, n))
        ci = rng.integers(0, 50, n)
        vals = rng.integers(1, 5, n).astype(np.float32)
        jplans.append(j_plan_chunks(ri, ci, vals, 40, chunk=32, span=16))
        plans.append(plan_chunks(ri, ci, vals, 40, chunk=32, span=16))
    want, got = j_stack_chunk_plans(jplans), stack_chunk_plans(plans)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == torch.from_numpy(v).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            assert got[k] == v, k
    stacked = ChunkPlan(**got)
    assert stacked.n_parts == 4 and stacked.n_chunks == got["count"].shape[1]
    for p, plan in enumerate(plans):  # each part's own window brackets
        assert torch.equal(stacked.window_start[p], plan.window_start)
        n = plan.n_chunks
        assert torch.equal(stacked.part(p).count[:n], plan.count)
    bad = plan_chunks([0], [0], [1.0], 8, chunk=32, span=8)
    with pytest.raises(ValueError, match="mismatched"):
        stack_chunk_plans([plans[0], bad])
    with pytest.raises(ValueError, match="at least one"):
        stack_chunk_plans([])


@pytest.mark.parametrize("scheme", ["1d.nnz", "1d.nnz-rgrn", "2d.equally-sized",
                                    "2d.variable-sized"])
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_kernel_chunk_arrays_match_jax_pallas_chunk_arrays(scheme, fmt):
    a = _matrix(np.float32, seed=6)
    head, tail = scheme.split(".")
    if head == "1d":
        tail = "nnz-rgrn" if fmt == "csr" else tail
        jp = JP.partition_1d(a, 4, fmt, tail, BLOCK)
        tp = TP.partition_1d(a, 4, fmt, tail, BLOCK)
    else:
        jp = JP.partition_2d(a, (2, 2), fmt, tail, BLOCK)
        tp = TP.partition_2d(a, (2, 2), fmt, tail, BLOCK)
    want = JD.pallas_chunk_arrays(jp, chunk=16)
    got = TD.kernel_chunk_arrays(tp, chunk=16)
    assert set(got) == set(want) | {"chunk_window_start", "chunk_pieces",
                                    "chunk_splits"}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="scalar formats"):
        TD.kernel_chunk_arrays(TP.partition_1d(a, 4, "bcoo", "nnz", BLOCK))


def test_kernel_block_arrays_are_per_part_pointers():
    a = _matrix(np.float32, seed=7)
    part = TP.partition_2d(a, (2, 2), "bcoo", "equally-wide", BLOCK)
    ptr = TD.kernel_block_arrays(part)["browptr"]
    n_brows = part.h_pad // BLOCK[0]
    assert ptr.shape == (4, n_brows + 1) and ptr.dtype == torch.int32
    for p in range(4):
        n = int(part.nnz[p])
        counts = np.bincount(part.rowind[p, :n].numpy(), minlength=n_brows)
        np.testing.assert_array_equal(ptr[p].numpy(),
                                      np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("balance", ["nnz", "rows"])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=lambda d: np.dtype(d).name)
def test_bucket_by_source_shard_matches_jax(balance, dtype):
    a = _matrix(dtype, seed=8)
    want, wcounts = JD.bucket_by_source_shard(JP.partition_1d(a, 4, "coo",
                                                              balance), 4)
    got, gcounts = TD.bucket_by_source_shard(TP.partition_1d(a, 4, "coo",
                                                             balance), 4)
    np.testing.assert_array_equal(gcounts, wcounts)
    assert_same_partition(got, want)
