"""MLA (repro_torch.models.attention: mla_apply / mla_decode / MLACache)
against the JAX package's ``repro.models.attention``.

deepseek-v3's reduced config (4 heads of 16, latent 32, q latent 48, rope
16); inputs from numpy seeds; JAX params cross as numpy arrays.  float32
within rtol = atol = 2e-4 (the port's tolerance for sums taken in another
order); bf16 within 4 bf16 ulps of the output's scale.  The query-chunked
path runs with ``CHUNKED_ATTN_THRESHOLD`` / ``Q_CHUNK`` monkeypatched in
both packages, as tests/test_torch_models.py does for GQA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as JA
from repro_torch import configs as tconfigs
from repro_torch.core.formats import to_tensor
from repro_torch.models import attention as TA
from repro_torch.models.common import map_params

TOL = dict(rtol=2e-4, atol=2e-4)


def cfgs():
    jc = get_config("deepseek-v3-671b").reduced()
    return jc, tconfigs.ArchConfig(**dataclasses.asdict(jc))


def layer(jc, dtype=jnp.float32, seed=0):
    p = JA.mla_init(jax.random.PRNGKey(seed), jc, dtype)
    return p, map_params(to_tensor, jax.tree.map(np.asarray, p))


def xs(shape, dtype=jnp.float32, seed=1):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape), dtype)
    return x, to_tensor(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("S", [1, 7, 24])
@pytest.mark.parametrize("B", [1, 3])
def test_mla_apply_matches_reference(B, S):
    jc, tc = cfgs()
    jp, tp = layer(jc)
    jx, tx = xs((B, S, jc.d_model))
    jout, jc_ = JA.mla_apply(jp, jx, jc)
    tout, tc_ = TA.mla_apply(tp, tx, tc)
    close(tout, jout)
    close(tc_.ckv, jc_.ckv)
    close(tc_.krope, jc_.krope)
    assert tuple(tc_.ckv.shape) == (B, S, jc.mla_kv_comp)
    assert tuple(tc_.krope.shape) == (B, S, jc.mla_rope_dim)
    assert tc_.length == int(jc_.length) == S


def test_mla_apply_with_positions():
    jc, tc = cfgs()
    jp, tp = layer(jc, seed=2)
    jx, tx = xs((2, 9, jc.d_model), seed=3)
    pos = np.random.default_rng(4).integers(0, 300, (2, 9)).astype(np.int32)
    jout, _ = JA.mla_apply(jp, jx, jc, positions=jnp.asarray(pos))
    tout, _ = TA.mla_apply(tp, tx, tc, positions=torch.from_numpy(pos))
    close(tout, jout)


def test_mla_apply_bf16():
    jc, tc = cfgs()
    jp, tp = layer(jc, jnp.bfloat16, seed=5)
    jx, tx = xs((2, 12, jc.d_model), jnp.bfloat16, seed=6)
    jout, _ = JA.mla_apply(jp, jx, jc)
    tout, _ = TA.mla_apply(tp, tx, tc)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(tout.float().numpy(), want, rtol=0,
                               atol=4 * 2 ** -8 * np.abs(want).max())


def _caches(jc, B, Sk, length, seed):
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((B, Sk, jc.mla_kv_comp)).astype(np.float32)
    kr = rng.standard_normal((B, Sk, jc.mla_rope_dim)).astype(np.float32)
    jcache = JA.MLACache(jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(length, jnp.int32))
    tcache = TA.MLACache(torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy()), length)
    return jcache, tcache


@pytest.mark.parametrize("length", [0, 5, 15, 16, 21])
def test_mla_decode_matches_reference(length):
    """A cache of 16: lengths below, at and past it (past max_len the
    reference overwrites the last slot; so does the port)."""
    jc, tc = cfgs()
    jp, tp = layer(jc, seed=7)
    jx, tx = xs((2, 1, jc.d_model), seed=8)
    jcache, tcache = _caches(jc, 2, 16, length, seed=9)
    jout, jnew = JA.mla_decode(jp, jx, jcache, jc)
    tout, tnew = TA.mla_decode(tp, tx, tcache, tc)
    close(tout, jout)
    close(tnew.ckv, jnew.ckv)
    close(tnew.krope, jnew.krope)
    assert tnew.length == int(jnew.length) == length + 1
    assert tnew.ckv is tcache.ckv and tnew.krope is tcache.krope  # in place


def test_mla_decode_past_max_len_overwrites_the_last_slot():
    """A reference behaviour kept for parity (ROADMAP.md §3): at length >=
    max_len both packages write the new latent into slot max_len - 1, keep
    every other slot, and attend over all max_len slots."""
    jc, tc = cfgs()
    jp, tp = layer(jc, seed=10)
    jx, tx = xs((1, 1, jc.d_model), seed=11)
    jcache, tcache = _caches(jc, 1, 8, 8, seed=12)
    before = tcache.ckv.clone()
    jout, jnew = JA.mla_decode(jp, jx, jcache, jc)
    tout, tnew = TA.mla_decode(tp, tx, tcache, tc)
    assert torch.equal(tnew.ckv[:, :7], before[:, :7])
    assert not torch.equal(tnew.ckv[:, 7], before[:, 7])
    want_last = (tx @ tp["w_dkv"]["w"])[:, 0]
    close(tnew.ckv[:, 7], want_last.numpy())
    np.testing.assert_array_equal(np.asarray(jnew.ckv)[:, :7], before[:, :7].numpy())
    close(tnew.ckv, jnew.ckv)
    close(tout, jout)
    assert tnew.length == int(jnew.length) == 9


def test_mla_prefill_then_decode_equals_longer_prefill():
    """decode(prefill(S)) at position S equals prefill(S+1)'s last row,
    within 5e-3 (tests/test_archs.py's bound) — here within 2e-4."""
    jc, tc = cfgs()
    _, tp = layer(jc, seed=13)
    _, tx = xs((2, 11, tc.d_model), seed=14)
    _, cache = TA.mla_apply(tp, tx[:, :10], tc)
    pad = (0, 0, 0, 6)
    cache = TA.MLACache(torch.nn.functional.pad(cache.ckv, pad),
                        torch.nn.functional.pad(cache.krope, pad), 10)
    got, _ = TA.mla_decode(tp, tx[:, 10:], cache, tc)
    want, _ = TA.mla_apply(tp, tx, tc)
    close(got[:, 0], want[:, -1].numpy())


@pytest.fixture
def chunked(monkeypatch):
    """Threshold 16 and chunk 8 in both packages; returns the port's chunk
    calls."""
    monkeypatch.setattr(JA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(JA, "Q_CHUNK", 8)
    monkeypatch.setattr(TA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(TA, "Q_CHUNK", 8)
    calls = []
    real = TA._mla_chunk
    monkeypatch.setattr(TA, "_mla_chunk",
                        lambda *a, **kw: calls.append(a[-1]) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("S", [16, 32, 20])
def test_mla_chunked_path_matches_reference(chunked, S):
    """S = 16 and 32 run query-chunked in both packages (offsets 0, 8, ...),
    S = 20 (not a multiple of the chunk) unchunked; the chunked port also
    agrees with the unchunked port."""
    jc, tc = cfgs()
    jp, tp = layer(jc, seed=15)
    jx, tx = xs((2, S, jc.d_model), seed=16)
    jout, _ = JA.mla_apply(jp, jx, jc)
    tout, tcache = TA.mla_apply(tp, tx, tc)
    assert chunked == (list(range(0, S, 8)) if S % 8 == 0 else [])
    close(tout, jout)
    assert tcache.length == S
    TA.CHUNKED_ATTN_THRESHOLD = S + 1
    unchunked, _ = TA.mla_apply(tp, tx, tc)
    close(tout, unchunked.numpy())


def test_mla_chunked_grads_match_jax(chunked):
    """Under autograd each chunk is recomputed in the backward pass
    (torch.utils.checkpoint): gradients of sum(out^2) in every param and x
    within 1e-5 of each leaf's largest |g| of jax.grad (whose chunks are
    jax.checkpoint'ed), f32."""
    jc, tc = cfgs()
    jp, tp = layer(jc, seed=17)
    jx, tx = xs((1, 16, jc.d_model), seed=18)
    jg, jgx = jax.grad(lambda p, x: jnp.sum(JA.mla_apply(p, x, jc)[0] ** 2),
                       argnums=(0, 1))(jp, jx)
    leaves = [v.clone().requires_grad_() for v in jax.tree.leaves(tp)]
    tpg = jax.tree.unflatten(jax.tree.structure(tp), leaves)
    txg = tx.clone().requires_grad_()
    (TA.mla_apply(tpg, txg, tc)[0] ** 2).sum().backward()
    assert len(chunked) == 4  # 2 chunks forward + 2 recomputed in backward
    for got, want in zip(leaves + [txg], jax.tree.leaves(jg) + [jgx]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_mla_init_tree_matches_reference():
    jc, tc = cfgs()
    jp = JA.mla_init(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = TA.mla_init(torch.Generator().manual_seed(0), tc, torch.float32)
    assert set(tp) == set(jp)
    for name in jp:
        assert tuple(tp[name]["w"].shape) == jp[name]["w"].shape, name
