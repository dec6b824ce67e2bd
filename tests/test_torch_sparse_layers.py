"""repro_torch.sparse (the block-sparse FFN layers) against the JAX
package's ``repro.sparse.layers``.

The same block values and activations (numpy, from a seed) go through
both.  On the CPU the port runs the block kernel's plain version, the
reference ``kref.bcoo_spmv_ref``: float32 results agree within
rtol = atol = 2e-4 (sums in another order).  bfloat16 results are f32
sums rounded to bf16, so two sums that differ in their last f32 bits may
round to neighbouring bf16 values: the tolerance is one bf16 ulp,
rtol = atol = 2**-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.sparse import layers as JL
from repro_torch import convert
from repro_torch.core.formats import to_tensor
from repro_torch.kernels.bcsr_spmv import block_row_ptr
from repro_torch.models.common import map_params
from repro_torch.sparse import layers as TL

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("brows,bcols,density", [
    (352, 8, 0.5), (128, 22, 0.5), (16, 4, 0.5), (7, 10, 0.3), (5, 3, 0.01),
    (64, 8, 1.0)])
def test_balanced_pattern_array_equal(brows, bcols, density):
    jr, jc = JL._balanced_pattern(brows, bcols, density)
    tr, tc = TL._balanced_pattern(brows, bcols, density)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tc, jc)
    assert tr.dtype == jr.dtype and tc.dtype == jc.dtype
    per_row = np.bincount(tr, minlength=brows)
    assert (per_row == per_row[0]).all()  # row-balanced by construction


def _layer(d_in, d_out, block, dtype, seed=0):
    p = JL.sparse_linear_init(jax.random.PRNGKey(seed), d_in, d_out, 0.5, block,
                              dtype)
    tp = TL.with_row_pointer(map_params(to_tensor, jax.tree.map(np.asarray, p)),
                             d_out)
    return p, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,d_in,d_out", [
    ((8, 16), 64, 128), ((8, 16), 128, 64), ((8, 128), 1024, 256),
    ((8, 128), 256, 1024)])
@pytest.mark.parametrize("lead", [(5,), (2, 3), (1, 1)])
def test_sparse_linear_apply(dtype, block, d_in, d_out, lead):
    p, tp = _layer(d_in, d_out, block, getattr(jnp, dtype))
    x = np.random.default_rng(1).standard_normal(lead + (d_in,)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = JL.sparse_linear_apply(p, jx, d_out)
    got = TL.sparse_linear_apply(tp, to_tensor(np.asarray(jx)), d_out)
    assert tuple(got.shape) == want.shape == lead + (d_out,)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(f32(got), f32(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_sparse_linear_matches_densified_weight():
    """y = x @ W^T with W (d_out, d_in) materialized from the blocks."""
    _, tp = _layer(128, 64, (8, 16), jnp.float32, seed=3)
    W = torch.zeros(64, 128)
    for k in range(tp["browind"].shape[0]):
        br, bc = int(tp["browind"][k]), int(tp["bcolind"][k])
        W[br * 8:(br + 1) * 8, bc * 16:(bc + 1) * 16] = tp["bvalues"][k]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 128))
                         .astype(np.float32))
    np.testing.assert_allclose(TL.sparse_linear_apply(tp, x, 64).numpy(),
                               (x @ W.T).numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [(1024, 2816), (2816, 1024), (64, 128)])
def test_init_shapes_pattern_and_row_pointer(shape):
    d_in, d_out = shape
    block = (8, 128) if d_in % 128 == 0 and d_in >= 1024 else (8, 16)
    gen = torch.Generator().manual_seed(0)
    p = TL.sparse_linear_init(gen, d_in, d_out, 0.5, block, torch.bfloat16)
    r, c = block
    jr, jc = JL._balanced_pattern(d_out // r, d_in // c, 0.5)
    np.testing.assert_array_equal(p["browind"].numpy(), jr)
    np.testing.assert_array_equal(p["bcolind"].numpy(), jc)
    assert p["bvalues"].shape == (len(jr), r, c)
    assert p["bvalues"].dtype == torch.bfloat16
    want = block_row_ptr(p["browind"], len(jr), d_out // r)
    assert torch.equal(p["browptr"], want) and p["browptr"].dtype == torch.int32
    assert int(p["browptr"][-1]) == len(jr)


def test_init_rejects_shapes_that_do_not_tile():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="does not tile"):
        TL.sparse_linear_init(gen, 100, 64, 0.5, (8, 16))


def test_stacked_row_pointer():
    gen = torch.Generator().manual_seed(0)
    layers = [TL.sparse_linear_init(gen, 64, 128, 0.5, (8, 16)) for _ in range(3)]
    stacked = {k: torch.stack([lp[k] for lp in layers])
               for k in ("browind", "bcolind", "bvalues")}
    got = TL.with_row_pointer(stacked, 128)["browptr"]
    assert got.shape == (3, 128 // 8 + 1)
    for r, lp in enumerate(layers):
        assert torch.equal(got[r], lp["browptr"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-27b"])
def test_block_sparse_ffn_apply(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), ffn_density=0.5,
                              sparse_block=(8, 16))
    p = JL.block_sparse_ffn_init(jax.random.PRNGKey(5), cfg, jnp.float32)
    tree = {"blocks": {"b0": {"mlp": jax.tree.map(np.asarray, p)}}}
    tp = convert.lm_params(tree, cfg)["blocks"]["b0"]["mlp"]
    for name in ("w_gate", "w_up", "w_down"):
        assert set(tp[name]) == {"browind", "bcolind", "bvalues", *TL.DERIVED}
        np.testing.assert_array_equal(tp[name]["bvalues"].numpy(),
                                      np.asarray(p[name]["bvalues"]))
    x = np.random.default_rng(6).standard_normal((2, 7, cfg.d_model)) \
        .astype(np.float32)
    want = JL.block_sparse_ffn_apply(p, jnp.asarray(x), cfg)
    got = TL.block_sparse_ffn_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
