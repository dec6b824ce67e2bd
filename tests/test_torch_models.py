"""repro_torch.configs and repro_torch.models against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's, with the JAX params carried across by
``repro_torch.convert.lm_params``; float32 at rtol = atol = 2e-4 (the
port's tolerance for sums taken in another order).  Sparse FFNs use (8, 16)
blocks: the reduced width (d_model 64) does not tile into (8, 128).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import spmv_paper as jspmv
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import spmv_paper as tspmv
from repro_torch.core.formats import to_tensor
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import lm as TLM

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = jconfigs.list_configs()


def port_cfg(cfg):
    """The port's ArchConfig with every field of a JAX one."""
    return tconfigs.ArchConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})


def reduced(arch, sparse=False):
    cfg = jconfigs.get_config(arch).reduced()
    if sparse:
        cfg = dataclasses.replace(cfg, ffn_density=0.5, sparse_block=(8, 16))
    return cfg, port_cfg(cfg)


def jtree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.asarray(a))


def TC_f(a):
    """numpy (bf16 by bit view) -> tensor."""
    return to_tensor(a)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------------ configs


def test_registry_lists_the_same_names():
    assert tconfigs.list_configs() == ARCHS
    assert tconfigs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    j, p = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(j.reduced())
    assert p.n_params == j.n_params
    assert p.active_params() == j.active_params()
    assert p.n_repeats == j.n_repeats
    assert p.shapes() == j.shapes()
    assert p.moe_capacity(4096) == j.moe_capacity(4096)


def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def test_spmv_paper_config_equals_reference():
    j, p = jspmv.spmv_paper_config(), tspmv.spmv_paper_config()
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for jsuite, psuite in ((j.small_suite(), p.small_suite()),
                           (j.large_suite(2), p.large_suite(2))):
        assert [dataclasses.asdict(s) for s in psuite] == \
            [dataclasses.asdict(s) for s in jsuite]


def test_qwen_full_width_sizes():
    cfg = tconfigs.get_config("qwen1.5-0.5b")
    assert cfg.n_params == 463_863_808
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    assert sparse.n_params == 360_054_784


# ------------------------------------------------------------------ common


@pytest.mark.parametrize("gemma_style", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(gemma_style, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx, jscale = jnp.asarray(x, dtype), jnp.asarray(scale, dtype)
    want = JC.rmsnorm({"scale": jscale}, jx, gemma_style=gemma_style)
    got = TC.rmsnorm({"scale": TC_f(np.asarray(jscale))}, TC_f(np.asarray(jx)),
                     gemma_style=gemma_style)
    assert str(got.dtype).endswith(dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    close(got.float(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = JC.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(TC.rope(t(x), t(pos), theta), want)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = (np.random.default_rng(2).standard_normal((4, 33)) * 40).astype(np.float32)
    close(TC.softcap(t(x), cap), JC.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_apply(act):
    rng = np.random.default_rng(3)
    p = JC.swiglu_init(jax.random.PRNGKey(0), 64, 128, jnp.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jact, tact = ((jax.nn.silu, torch.nn.functional.silu) if act == "silu"
                  else (jax.nn.gelu, TC.gelu))
    want = JC.swiglu_apply(p, jnp.asarray(x), act=jact)
    got = TC.swiglu_apply(TC.map_params(TC_f, jtree(p)), t(x), act=tact)
    close(got, want)


def test_dense_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = TC.dense_bias_init(gen, 256, 64, torch.float32)
    assert p["w"].shape == (256, 64) and p["b"].shape == (64,)
    assert abs(float(p["w"].std()) - 1 / 16) < 0.01
    assert not p["b"].any()


# ------------------------------------------------------------------ attention


def _attn_inputs(cfg, S, seed=4):
    rng = np.random.default_rng(seed)
    p = JA.gqa_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return p, TC.map_params(TC_f, jtree(p)), x


ATTN_CASES = [("qwen1.5-0.5b", None, None), ("smollm-360m", None, None),
              ("gemma2-27b", 16, 50.0), ("gemma2-27b", 8, None)]


@pytest.mark.parametrize("arch,window,cap", ATTN_CASES)
def test_gqa_apply(arch, window, cap):
    jc, tc = reduced(arch)
    p, tp, x = _attn_inputs(jc, 24)
    jout, jkv = JA.gqa_apply(p, jnp.asarray(x), jc, window=window, attn_cap=cap)
    tout, tkv = TA.gqa_apply(tp, t(x), tc, window=window, attn_cap=cap)
    close(tout, jout)
    close(tkv.k, jkv.k)
    close(tkv.v, jkv.v)
    assert tkv.length == int(jkv.length) == 24


@pytest.mark.parametrize("arch,window,cap", ATTN_CASES)
@pytest.mark.parametrize("length", [5, 16, 21])
def test_gqa_decode(arch, window, cap, length):
    """Window 8 < cache 16 wraps the ring; window None overwrites the last
    slot once the cache is full, as the reference does."""
    jc, tc = reduced(arch)
    p, tp, x = _attn_inputs(jc, 1, seed=5)
    rng = np.random.default_rng(6)
    S = 16 if window is None else min(16, window)
    k = rng.standard_normal((2, S, jc.n_kv_heads, jc.head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    jcache = JA.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(length, jnp.int32))
    tcache = TA.KVCache(t(k.copy()), t(v.copy()), length)
    jout, jnew = JA.gqa_decode(p, jnp.asarray(x), jcache, jc, window=window,
                               attn_cap=cap)
    tout, tnew = TA.gqa_decode(tp, t(x), tcache, tc, window=window, attn_cap=cap)
    close(tout, jout)
    close(tnew.k, jnew.k)
    close(tnew.v, jnew.v)
    assert tnew.length == int(jnew.length) == length + 1
    assert tnew.k is tcache.k  # written in place


@pytest.mark.parametrize("window,cap", [(None, None), (12, 50.0)])
def test_chunked_attention_path(monkeypatch, window, cap):
    """Threshold 16 and chunk 8 in both packages: a 32-token prefill runs
    query-chunked in both, and agrees with the unchunked port."""
    jc, tc = reduced("gemma2-27b")
    p, tp, x = _attn_inputs(jc, 32, seed=7)
    unchunked, _ = TA.gqa_apply(tp, t(x), tc, window=window, attn_cap=cap)
    monkeypatch.setattr(JA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(JA, "Q_CHUNK", 8)
    monkeypatch.setitem(JA._sdpa_qchunked.__kwdefaults__, "q_chunk", 8)
    monkeypatch.setattr(TA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(TA, "Q_CHUNK", 8)
    calls = []
    real = TA._sdpa_qchunked
    monkeypatch.setattr(TA, "_sdpa_qchunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jout, _ = JA.gqa_apply(p, jnp.asarray(x), jc, window=window, attn_cap=cap)
    tout, _ = TA.gqa_apply(tp, t(x), tc, window=window, attn_cap=cap)
    assert calls == [1]
    close(tout, jout)
    close(tout, unchunked.numpy())


def test_chunk_size_must_divide_sequence():
    q = torch.zeros(1, 12, 2, 4)
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        TA._sdpa_qchunked(q, q, q, causal=True, window=None, cap=None,
                          scale=None, q_chunk=8)


@pytest.mark.parametrize("window", [None, 5])
def test_causal_mask(window):
    want = np.asarray(JA.causal_mask(9, 9, window))
    np.testing.assert_array_equal(TA.causal_mask(9, 9, window).numpy(), want)


# ------------------------------------------------------------------ blocks

KIND_CASES = [("qwen1.5-0.5b", "attn"), ("gemma2-27b", "attn_local"),
              ("gemma2-27b", "attn_global"), ("mixtral-8x22b", "moe"),
              ("deepseek-v3-671b", "mla_dense"), ("deepseek-v3-671b", "mla_moe"),
              ("seamless-m4t-medium", "cross_attn")]


def cache_tensors(c):
    """A KVCache's (k, v) or an MLACache's (ckv, krope)."""
    return c[:-1]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("arch,kind", KIND_CASES)
def test_block_apply_and_decode(arch, kind, sparse):
    """Every ported kind at the default MoE capacity (both packages drop
    the same assignments); sparse blocks run the block-sparse FFN where
    the kind has a dense MLP (the MoE kinds' experts stay dense);
    cross_attn reads an encoder memory of another length (13) than the
    block's sequence."""
    jc, tc = reduced(arch, sparse)
    p = JB.block_init(jax.random.PRNGKey(8), jc, kind, jnp.float32)
    tp = convert.lm_params({"blocks": {"b0": jtree(p)}}, tc)["blocks"]["b0"]
    assert set(tp) == set(p)
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 20, jc.d_model)).astype(np.float32)
    jmem = tmem = None
    if kind == "cross_attn":
        mem = rng.standard_normal((2, 13, jc.d_model)).astype(np.float32)
        jmem, tmem = jnp.asarray(mem), t(mem)
    jh, jkv = JB.block_apply(p, jnp.asarray(h), jc, kind, memory=jmem)
    th, tkv = TB.block_apply(tp, t(h), tc, kind, memory=tmem)
    close(th, jh)
    assert type(tkv).__name__ == type(jkv).__name__
    for a, b in zip(cache_tensors(tkv), cache_tensors(jkv)):
        close(a, b)
    # decode one token against a grown cache of the prefill's K/V (latents)
    jcache = JLM._grow_cache(jkv, jc, kind, 32)
    tcache = TLM._grow_cache(tkv, tc, kind, 32)
    for a, b in zip(cache_tensors(tcache), cache_tensors(jcache)):
        assert a.shape == b.shape
    h1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    jh1, jnew = JB.block_decode(p, jnp.asarray(h1), jcache, jc, kind, memory=jmem)
    th1, tnew = TB.block_decode(tp, t(h1), tcache, tc, kind, memory=tmem)
    close(th1, jh1)
    for a, b in zip(cache_tensors(tnew), cache_tensors(jnew)):
        close(a, b)
    assert tnew.length == 21


@pytest.mark.parametrize("arch,kind", KIND_CASES)
def test_init_cache_shapes(arch, kind):
    jc, tc = reduced(arch)
    want = JB.init_cache(jc, kind, 3, 40, jnp.float32)
    got = TB.init_cache(tc, kind, 3, 40, torch.float32)
    assert type(got).__name__ == type(want).__name__ and got.length == 0
    for a, b in zip(cache_tensors(got), cache_tensors(want)):
        assert tuple(a.shape) == b.shape
    caches = TLM.init_caches(tc, 3, 40, torch.float32)
    jcaches = JLM.init_caches(jc, 3, 40, jnp.float32)
    assert len(caches.prefix) == len(jcaches.prefix) and caches.mtp is None
    for c, jcache in list(zip(caches.prefix, jcaches.prefix)) + [
            (c, jcaches.blocks[key]) for key, c in caches.blocks.items()]:
        for a, b in zip(cache_tensors(c), cache_tensors(jcache)):
            assert tuple(a.shape) == b.shape
            assert not a.any()
        assert c.length == 0


def test_unknown_kind_raises():
    _, tc = reduced("qwen1.5-0.5b")
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: TB.block_init(gen, tc, "no-such-kind"),
                 lambda: TB.init_cache(tc, "no-such-kind", 1, 8),
                 lambda: TB.check_kind("no-such-kind")):
        with pytest.raises(ValueError, match="unknown block kind"):
            call()
    with pytest.raises(ValueError, match="unknown block kind"):
        TLM.check_config(dataclasses.replace(tc, block_pattern=("no-such-kind",)))


def test_encoder_and_mtp_raise():
    """Neither raises any longer: the encoder (seamless-m4t-medium) and
    multi-token prediction are ported and build the reference's
    ``encoder`` and ``mtp`` trees."""
    jc, tc = reduced("seamless-m4t-medium")
    assert tc.encoder_layers == 2
    TLM.check_config(tc)
    jp = JLM.init_params(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = TLM.init_params(torch.Generator().manual_seed(0), tc, torch.float32)
    assert set(tp["encoder"]) == set(jp["encoder"]) == {"blocks", "norm", "in_proj"}
    assert set(tp["encoder"]["blocks"]) == set(jp["encoder"]["blocks"])
    assert tuple(tp["encoder"]["in_proj"]["w"].shape) == \
        jp["encoder"]["in_proj"]["w"].shape
    assert tuple(tp["encoder"]["blocks"]["mlp"]["w_up"]["w"].shape) == \
        jp["encoder"]["blocks"]["mlp"]["w_up"]["w"].shape
    jc, tc = reduced("deepseek-v3-671b")
    assert tc.mtp_depth == 1
    TLM.check_config(tc)
    jp = JLM.init_params(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = TLM.init_params(torch.Generator().manual_seed(0), tc, torch.float32)
    assert set(tp["mtp"]) == set(jp["mtp"]) == {"proj", "norm", "block"}
    assert set(tp["mtp"]["block"]) == set(jp["mtp"]["block"])
    assert tuple(tp["mtp"]["proj"]["w"].shape) == jp["mtp"]["proj"]["w"].shape
