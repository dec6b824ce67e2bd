"""The dense family's last three archs against the JAX package: gemma2-27b
past its sliding window, llava-next-34b's modality prefix through the step
builders, and the sparse gemma2 FFN's activation.

Reduced widths (``ArchConfig.reduced()``: d_model 64, window 16, an
8-token llava prefix), f32 params from the reference's init carried across
by ``convert.lm_params``; tokens and prefix embeddings from numpy seeds.
Logits agree within rtol = atol = 2e-4 (tests/test_torch_lm_serve.py's
bound); a train step's loss within 1e-5 relative, each grad leaf within
1e-4 of its max |g| and updated params within 1e-5 wherever |g| > 1e-3 ·
max |g| (tests/test_torch_train_step.py's bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config
from repro.launch import steps as JS
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as TS
from repro_torch.models import blocks as TB
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TA
from repro_torch.sparse import layers as TL
from repro_torch.tree import leaves as tleaves

TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
B = 2


def configs(arch, sparse=False):
    jc = get_config(arch).reduced()
    if sparse:
        jc = dataclasses.replace(jc, ffn_density=0.5, sparse_block=(8, 16))
    return jc, tconfigs.ArchConfig(**dataclasses.asdict(jc))


def models(arch, sparse=False, seed=1):
    jc, tc = configs(arch, sparse)
    params = JLM.init_params(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jc, tc, params, convert.lm_params(jax.tree.map(np.asarray, params), tc)


def assert_caches_match(tcache, jcache):
    pairs = list(zip(tcache.prefix, jcache.prefix)) + [
        (c, jcache.blocks[key]) for key, c in tcache.blocks.items()]
    for c, jc_ in pairs:
        for a, b in zip(c[:-1], jc_[:-1]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------ gemma2 across the window


@pytest.mark.parametrize("S", [32, 24], ids=["ring_aligned", "ring_out_of_step"])
def test_gemma2_prefill_past_the_window_then_decode_matches_reference(S):
    """A prefill of twice the reduced window (16), where ``_grow_cache``
    keeps the last 16 entries and decode's slot ``pos % 16`` is the oldest,
    and one of 1.5 windows, where the ring is out of step with the
    positions (the reference's behaviour, which the port keeps): the
    prefill's logits and caches, then three decode steps' logits, within
    2e-4 of the reference's."""
    jc, tc, params, tparams = models("gemma2-27b")
    assert jc.sliding_window == 16 and tc.block_pattern == ("attn_local", "attn_global")
    toks = np.random.default_rng(S).integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    max_len = S + 8
    jl, jcache = JLM.prefill(params, jnp.asarray(toks[:, :S]), jc, max_len)
    with torch.no_grad():
        tl, tcache = TLM.prefill(tparams, torch.from_numpy(toks[:, :S]), tc, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache.blocks["b0"].k.shape[2] == jc.sliding_window  # the local ring
    assert tcache.blocks["b1"].k.shape[2] == max_len  # the global layer
    assert_caches_match(tcache, jcache)
    nxt = toks[:, S:]
    for step in range(3):
        jl, jcache = JLM.decode_step(params, jnp.asarray(nxt), jcache, jc)
        with torch.no_grad():
            tl, tcache = TLM.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_gemma2_decode_past_an_aligned_window_equals_a_longer_prefill():
    """With the ring aligned (S = 2 windows), decode(prefill(S)) is
    prefill(S + 1) within tests/test_archs.py's 5e-3, in both packages; at
    S = 24 the reference's own pair differs, and the port's by as much."""
    jc, tc, params, tparams = models("gemma2-27b")
    toks = np.random.default_rng(7).integers(0, jc.vocab, (B, 33)).astype(np.int32)
    errs = {}
    for S in (32, 24):
        _, jcache = JLM.prefill(params, jnp.asarray(toks[:, :S]), jc, 40)
        jgot, _ = JLM.decode_step(params, jnp.asarray(toks[:, S:S + 1]), jcache, jc)
        jwant, _ = JLM.prefill(params, jnp.asarray(toks[:, :S + 1]), jc, 40)
        with torch.no_grad():
            _, tcache = TLM.prefill(tparams, torch.from_numpy(toks[:, :S]), tc, 40)
            tgot, _ = TLM.decode_step(tparams, torch.from_numpy(toks[:, S:S + 1]),
                                      tcache, tc)
            twant, _ = TLM.prefill(tparams, torch.from_numpy(toks[:, :S + 1]), tc, 40)
        jerr = float(np.abs(np.asarray(jgot) - np.asarray(jwant)).max())
        terr = float((tgot - twant).abs().max())
        errs[S] = (jerr, terr)
        np.testing.assert_allclose(terr, jerr, rtol=1e-2, atol=1e-5)
    assert errs[32][1] <= 5e-3
    assert errs[24][0] > 5e-3  # the reference's out-of-step ring, kept


# ------------------------------------------------ sparse gemma2's activation


def test_sparse_gemma2_ffn_takes_silu_as_the_reference():
    """The dense gemma2 FFN takes tanh-GELU; the block-sparse one takes
    SiLU in both packages (``repro/sparse/layers.py:block_sparse_ffn_apply``).
    The port's sparse ``_mlp_apply`` matches the reference's within 2e-4 and
    a SiLU SwiGLU of the densified weights, and is not the GELU one."""
    jc, tc, params, tparams = models("gemma2-27b", sparse=True)
    assert tc.gemma_norm and tc.ffn_density < 1
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["mlp"])
    tp = {name: {k: v[0] for k, v in leaf.items()}
          for name, leaf in tparams["blocks"]["b0"]["mlp"].items()}
    x = np.random.default_rng(3).standard_normal((B, 5, jc.d_model)).astype(np.float32)
    want = np.asarray(JB._mlp_apply(jp, jnp.asarray(x), jc))
    with torch.no_grad():
        got = TB._mlp_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    def dense(p, d_in, d_out):
        nb, r, c = p["bvalues"].shape
        w = torch.zeros(d_out // r, d_in // c, r, c)
        w[p["browind"].long(), p["bcolind"].long()] = p["bvalues"]
        return w.transpose(1, 2).reshape(d_out, d_in)

    d, f = tc.d_model, tc.d_ff
    xt = torch.from_numpy(x)
    wg, wu, wd = dense(tp["w_gate"], d, f), dense(tp["w_up"], d, f), dense(tp["w_down"], f, d)
    silu = (F.silu(xt @ wg.T) * (xt @ wu.T)) @ wd.T
    gelu = (F.gelu(xt @ wg.T, approximate="tanh") * (xt @ wu.T)) @ wd.T
    np.testing.assert_allclose(got.numpy(), silu.numpy(), **TOL)
    assert float((got - gelu).abs().max()) > 1e-2


# ------------------------------------------------ llava's prefix, step builders


def _llava_inputs(jc, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    pe = rng.standard_normal((B, jc.modality_tokens, jc.d_model)).astype(np.float32)
    return toks, pe


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_llava_prefill_and_decode_steps_with_a_prefix_match_reference(sparse):
    """``make_prefill_step(cfg, "prefill_32k")`` with ``prefix_embeds`` in
    the batch (caches of 32,768 slots) and two ``make_decode_step`` steps
    against the reference's step builders; the prefill step equal to the
    bit to ``lm.prefill(..., prefix_embeds=)`` at the same max_len."""
    jc, tc, params, tparams = models("llava-next-34b", sparse)
    assert jc.modality_tokens == 8
    S = 12
    toks, pe = _llava_inputs(jc, S, 5)
    jl, jcache = JS.make_prefill_step(jc, "prefill_32k")(
        params, {"tokens": jnp.asarray(toks[:, :S]), "prefix_embeds": jnp.asarray(pe)})
    with torch.no_grad():
        batch = {"tokens": torch.from_numpy(toks[:, :S]),
                 "prefix_embeds": torch.from_numpy(pe)}
        tl, tcache = TS.make_prefill_step(tc, "prefill_32k")(tparams, batch)
        direct, _ = TLM.prefill(tparams, batch["tokens"], tc, 32768,
                                prefix_embeds=batch["prefix_embeds"])
    assert torch.equal(tl, direct)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache.blocks["b0"].k.shape[2] == 32768
    assert tcache.blocks["b0"].length == S + jc.modality_tokens
    assert_caches_match(tcache, jcache)
    nxt = toks[:, S:]
    for step in range(2):
        jl, jcache = JS.make_decode_step(jc, "decode_32k")(
            params, {"token": jnp.asarray(nxt), "caches": jcache})
        with torch.no_grad():
            tl, tcache = TS.make_decode_step(tc, "decode_32k")(
                tparams, {"token": torch.from_numpy(nxt), "caches": tcache})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert tcache.blocks["b0"].length == S + jc.modality_tokens + 2


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_llava_train_step_with_a_prefix_matches_reference(sparse):
    """One ``make_train_step`` on a batch with ``prefix_embeds`` against the
    jitted reference step (f32, AdamW): the loss over the text positions
    within 1e-5 relative, each grad leaf within 1e-4 of its max |g|, the
    updated params within 1e-5 wherever |g| > 1e-3 · max |g|."""
    jc, tc, params, tparams = models("llava-next-34b", sparse, seed=2)
    toks, pe = _llava_inputs(jc, 15, 6)
    batch = {"tokens": toks[:, :16], "labels": toks[:, :16], "prefix_embeds": pe}
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jopt = JA.init_opt(params, JA.AdamWConfig(**OPT))
    topt = TA.init_opt(TL.strip_derived(tparams), TA.AdamWConfig(**OPT))
    jloss, jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                        static_argnums=2)(params, jb, jc)
    tloss, tg = TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jgl, tgl = jax.tree.leaves(jg), tleaves(TL.strip_derived(tg))
    assert len(jgl) == len(tgl)
    for a, b in zip(tgl, jgl):
        b = np.asarray(b)
        if b.dtype.kind != "f":
            continue
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))
    jp, _, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**OPT)))(params, jopt, jb)
    tp, to, tm = TS.make_train_step(tc, TA.AdamWConfig(**OPT))(tparams, topt, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(to.step) == 1
    for a, b, g in zip(tleaves(TL.strip_derived(tp)), jax.tree.leaves(jp), jgl):
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(g))
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        big = g > 1e-3 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-5)
