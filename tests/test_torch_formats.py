"""repro_torch.core against repro.core: formats, triplet builders, stats and
scheme selection on the same numpy inputs, compared array for array."""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as JA
from repro.core import formats as JF
from repro.core.stats import compute_stats as j_compute_stats
from repro_torch import convert
from repro_torch.core import adaptive as TA
from repro_torch.core import formats as TF
from repro_torch.core.stats import compute_stats as t_compute_stats

from _torch_common import BF16, assert_same_fields, np_of, rand_sparse

DTYPES = [np.float32, BF16, np.int8, np.int16, np.int32]  # JAX runs without x64
BUILDERS = {
    "csr": (JF.dense_to_csr, TF.dense_to_csr, TF.triplets_to_csr),
    "coo": (JF.dense_to_coo, TF.dense_to_coo, TF.triplets_to_coo),
    "bcsr": (JF.dense_to_bcsr, TF.dense_to_bcsr, TF.triplets_to_bcsr),
    "bcoo": (JF.dense_to_bcoo, TF.dense_to_bcoo, TF.triplets_to_bcoo),
}


def _kwargs(fmt, block, capacity):
    kw = {"capacity": capacity}
    if fmt.startswith("b"):
        kw["block"] = block
    return kw


def _matrix(dtype, seed):
    a = rand_sparse(48, 64, 0.12, dtype=np.float32, seed=seed, integer=True)
    a[5] = 0  # an empty row (and, for (8, 16) blocks, part of a block-row)
    a[40:48] = 0  # an empty block-row
    return a.astype(dtype)


@pytest.mark.parametrize("fmt", list(BUILDERS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("block,capacity", [((8, 16), None), ((4, 8), 400)])
def test_dense_and_triplet_builders_match_jax(fmt, dtype, block, capacity):
    a = _matrix(dtype, seed=3)
    jb, tb, trip = BUILDERS[fmt]
    kw = _kwargs(fmt, block, capacity)
    want = jb(a, **kw)
    assert_same_fields(tb(a, **kw), want)
    # triplets: shuffled, with explicit zeros, and the first five entries
    # split into duplicates (v - 1) + 1 — exact for these integer values
    ri, ci = np.nonzero(a)
    vals = a[ri, ci].copy()
    vals[:5] = vals[:5] - 1
    ri = np.concatenate([ri, ri[:5], [0, 47]])
    ci = np.concatenate([ci, ci[:5], [63, 0]])
    vals = np.concatenate([vals, np.ones(5, a.dtype), np.zeros(2, a.dtype)])
    order = np.random.default_rng(0).permutation(len(ri))
    assert_same_fields(trip(ri[order], ci[order], vals[order], a.shape, **kw),
                       want)


def test_triplets_sum_duplicates_and_drop_cancellations():
    dense = np.zeros((16, 16), np.float32)
    ri = np.array([3, 3, 3, 1, 7, 7])
    ci = np.array([4, 4, 4, 2, 0, 0])
    v = np.array([1, 2, -0.5, 5, 3, -3], np.float32)
    np.add.at(dense, (ri, ci), v)
    for fmt, (jb, _, trip) in BUILDERS.items():
        kw = _kwargs(fmt, (8, 8), None)
        assert_same_fields(trip(ri, ci, v, dense.shape, **kw), jb(dense, **kw))


def test_block_keep_rule_wraps_like_numpy():
    """abs(int8 -128) wraps to -128, so a tile of [-128, 64, 64] sums to 0
    and the dense builder drops it; the port keeps that rule."""
    a = np.zeros((16, 32), np.int8)
    a[0, :3] = [-128, 64, 64]
    a[9, 20] = 1
    for fmt in ("bcsr", "bcoo"):
        jb, tb, trip = BUILDERS[fmt]
        want = jb(a, block=(8, 16))
        assert int(np.asarray(want.bcolind).shape[0]) == 1
        assert_same_fields(tb(a, block=(8, 16)), want)
        ri, ci = np.nonzero(a)
        assert_same_fields(trip(ri, ci, a[ri, ci], a.shape, block=(8, 16)), want)


def test_empty_matrix_builders_match_jax():
    a = np.zeros((16, 32), np.float32)
    for fmt, (jb, tb, trip) in BUILDERS.items():
        kw = _kwargs(fmt, (8, 16), None)
        want = jb(a, **kw)
        assert_same_fields(tb(a, **kw), want)
        empty = np.zeros(0, np.int64)
        assert_same_fields(trip(empty, empty, np.zeros(0, np.float32), a.shape,
                                **kw), want)


@pytest.mark.parametrize("fmt", list(BUILDERS))
def test_to_dense_and_conversions_match_jax(fmt):
    a = _matrix(np.float32, seed=5)
    jb, tb, _ = BUILDERS[fmt]
    kw = _kwargs(fmt, (8, 16), 500)
    np.testing.assert_array_equal(TF.to_dense(tb(a, **kw)).numpy(), a)
    # the converter carries the JAX container across unchanged
    jm = jb(a, **kw)
    fields = {k: np.asarray(getattr(jm, k)) for k in jm.__dataclass_fields__}
    assert_same_fields(convert.container(fmt, fields), jm)
    if fmt == "csr":
        assert_same_fields(TF.csr_to_coo(tb(a, **kw)), JF.csr_to_coo(jm))
    if fmt == "coo":
        assert_same_fields(TF.coo_to_csr(tb(a, **kw)), JF.coo_to_csr(jm))


def test_to_tensor_takes_numpy_bfloat16_by_bits():
    a = np.array([1.5, -2.0, 3.0e-3, 0.0], BF16)
    t = TF.to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_of(t), a.view(np.int16))
    assert TF.torch_dtype(BF16) == torch.bfloat16
    assert TF.dtype_name(jnp.bfloat16) == "bfloat16"


@pytest.mark.parametrize("kind", ["regular", "scale-free", "block"])
@pytest.mark.parametrize("block", [(8, 16), (8, 128)])
def test_stats_match_jax(kind, block):
    from repro.data.matrices import block_matrix, regular_matrix, scale_free_matrix

    a = {"regular": lambda: regular_matrix(96, 256, 5, seed=1),
         "scale-free": lambda: scale_free_matrix(256, 256, 6000, seed=2),
         "block": lambda: block_matrix(96, 256, block=(8, 16), seed=3)}[kind]()
    want = asdict(j_compute_stats(a, block=block))
    assert asdict(t_compute_stats(a, block=block)) == want
    assert asdict(t_compute_stats(torch.from_numpy(a), block=block)) == want
    ri, ci = np.nonzero(a)
    assert asdict(t_compute_stats((ri, ci, a.shape), block=block)) == want


@pytest.mark.parametrize("chips", [1, 4, 16, 64])
def test_select_scheme_matches_jax(chips):
    from repro.data.matrices import block_matrix, regular_matrix, scale_free_matrix

    for a in (regular_matrix(64, 512, 5, seed=1),
              scale_free_matrix(256, 256, 6000, seed=2),
              block_matrix(96, 256, block=(8, 16), seed=3)):
        st = j_compute_stats(a, block=(8, 16))
        jp = JA.select_scheme(st, JA.HardwareModel(chips=chips))
        tp = TA.select_scheme(t_compute_stats(a, block=(8, 16)),
                              TA.HardwareModel(chips=chips))
        assert tp.tag == jp.tag and tp.grid == jp.grid and tp.reason == jp.reason
        jc = JA.enumerate_schemes(st, JA.HardwareModel(chips=chips))
        tc = TA.enumerate_schemes(st, TA.HardwareModel(chips=chips))
        assert tc[0].tag == jc[0].tag
        assert sorted(p.tag for p in tc) == sorted(p.tag for p in jc)


def test_hardware_model_is_the_h100():
    hw = TA.HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
