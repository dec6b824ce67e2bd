"""The port's training pieces against the JAX package: the token stream,
the loss, AdamW (plain and with int8 moments), error-feedback compression,
the block-sparse FFN's backward and one whole train step.

Inputs are made with numpy from a seed and handed to both packages; JAX
params cross by ``convert.lm_params``.  JAX runs as its own tests run it:
``make_train_step`` under ``jax.jit``.  Tolerances, each stated where it
is used, come from float32 sums taken in another order: 1e-6 for the
optimizer's elementwise arithmetic, 1e-5 relative for a loss, 1e-4 of a
leaf's largest gradient for gradients (backward passes sum over tokens
and layers), bit-equality wherever the inputs are integer-valued.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import tokens as JT
from repro.launch import steps as JS
from repro.models import common as JC
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro.optim import compress as JCMP
from repro.sparse import layers as JL
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.formats import to_tensor
from repro_torch.data import tokens as TT
from repro_torch.kernels.bcsr_spmv import transposed_stream, transposed_values
from repro_torch.launch import steps as TS
from repro_torch.models import common as TC
from repro_torch.models.common import map_params
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TCMP
from repro_torch.sparse import layers as TL
from repro_torch.tree import leaves as tleaves

from _torch_common import BF16, np_of


def port_cfg(jc):
    return tconfigs.ArchConfig(**dataclasses.asdict(jc))


def t(a):
    """numpy tree (bf16 by bits) -> tensor tree, through the port's converter."""
    return map_params(to_tensor, a)


# --------------------------------------------------------------- tokens


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (3, 7), (11, 123456)])
def test_make_batch_array_equal(seed, step):
    want = JT.make_batch(97, 33, 4, seed, step)
    got = TT.make_batch(97, 33, 4, seed, step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32 and got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    stream = TT.TokenStream(97, 33, 4, seed)
    np.testing.assert_array_equal(stream.batch(step)["tokens"].numpy(),
                                  got["tokens"].numpy())


# --------------------------------------------------------------- loss


@pytest.mark.parametrize("mask", [None, "float", "bool"])
def test_cross_entropy_matches_reference(mask):
    """Within 1e-6: logsumexp and a mean over 60 tokens in f32."""
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 20, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 20)).astype(np.int32)
    m = None
    if mask is not None:
        m = rng.random((3, 20)) < 0.6
        m = m.astype(np.float32) if mask == "float" else m
    want = JC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
    got = TC.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cross_entropy_reads_bf16_logits_in_f32():
    logits = np.random.default_rng(2).standard_normal((2, 5, 9)).astype(BF16)
    labels = np.arange(10, dtype=np.int32).reshape(2, 5) % 9
    want = JC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TC.cross_entropy(t(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------- AdamW


def _tree(dtype_name):
    rng = np.random.default_rng(3)
    dt = BF16 if dtype_name == "bfloat16" else np.float32
    return {"w": rng.standard_normal((8, 6)).astype(dt),
            "b10": {"c": rng.standard_normal((5,)).astype(dt)},
            "b2": {"idx": np.arange(4, dtype=np.int32)},
            "s": np.asarray(0.5, dtype=dt)}


def _grads(tree, k):
    rng = np.random.default_rng(10 + k)
    return jax.tree.map(
        lambda p: (3 * rng.standard_normal(p.shape)).astype(p.dtype)
        if p.dtype != np.int32 else np.zeros_like(p), tree)


def _assert_moments(got, want, quantized):
    if not quantized:
        for a, b in zip(tleaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        return
    is_vq = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}  # noqa: E731
    for a, b in zip(tleaves(got, is_vq), jax.tree.leaves(want, is_leaf=is_vq)):
        assert a["q"].dtype == torch.int8 and a["scale"].dtype == torch.float32
        # max |moment| / 127: two f32 ulps (2**-22), since the grad norms
        # (sums in another order) already differ in their last bit
        np.testing.assert_allclose(float(a["scale"]), float(b["scale"]),
                                   rtol=2 ** -22)
        # equal but at rounding ties, where f32 noise picks the neighbour
        diff = np.abs(a["q"].numpy().astype(int) - np.asarray(b["q"]).astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.9


@pytest.mark.parametrize("qm,qv", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(dtype, qm, qv):
    """Identical grads fed to both: params, m and v within 1e-6 after 3
    steps (bf16 params compared as f32: an update rounds to the same bf16
    unless the f32 values straddle a rounding boundary)."""
    cfg = dict(lr_peak=0.1, warmup_steps=2, total_steps=10, quantized_m=qm,
               quantized_v=qv)
    tree = _tree(dtype)
    jp, tp = jax.tree.map(jnp.asarray, tree), t(tree)
    jopt, topt = JA.init_opt(jp, JA.AdamWConfig(**cfg)), TA.init_opt(tp, TA.AdamWConfig(**cfg))
    assert int(topt.step) == 0 and topt.step.dtype == torch.int32
    for k in range(3):
        g = _grads(tree, k)
        jp, jopt, jm = JA.apply_updates(jp, jax.tree.map(jnp.asarray, g), jopt,
                                        JA.AdamWConfig(**cfg))
        tp, topt, tm = TA.apply_updates(tp, t(g), topt, TA.AdamWConfig(**cfg))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
    assert int(topt.step) == 3
    for a, b in zip(tleaves(tp), jax.tree.leaves(jp)):
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tp["b2"]["idx"].numpy(), tree["b2"]["idx"])
    _assert_moments(topt.m, jopt.m, qm)
    _assert_moments(topt.v, jopt.v, qv)


def test_opt_state_mirrors_the_tree_with_f32_zeros_for_integer_leaves():
    tree = _tree("bfloat16")
    for qm in (False, True):
        cfg = dict(quantized_m=qm)
        jopt = JA.init_opt(jax.tree.map(jnp.asarray, tree), JA.AdamWConfig(**cfg))
        topt = TA.init_opt(t(tree), TA.AdamWConfig(**cfg))
        jl, tl = jax.tree.leaves(jopt), tleaves(topt)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert np_of(a).dtype == np_of(b).dtype and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(np_of(a), np_of(b))


def test_warmup_cosine_matches_reference():
    cfg = dict(lr_peak=3e-3, warmup_steps=7, total_steps=40)
    for step in range(0, 43):
        want = JA.warmup_cosine(JA.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
        got = TA.warmup_cosine(TA.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7, atol=1e-7)
    assert float(TA.warmup_cosine(TA.AdamWConfig(**cfg), 0)) == 0.0


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_clip_matches_reference(max_norm):
    g = _grads(_tree("float32"), 0)
    want, wn = JA.global_norm_clip(jax.tree.map(jnp.asarray, g), max_norm)
    got, gn = TA.global_norm_clip(t(g), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for a, b in zip(tleaves(got), jax.tree.leaves(want)):
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_adamw_converges_on_a_quadratic():
    """The port's counterpart of tests/test_optim.py:test_adamw_converges."""
    cfg = TA.AdamWConfig(lr_peak=0.3, warmup_steps=5, total_steps=200,
                         weight_decay=0.0, quantized_v=True)
    params = {"a": torch.ones((8, 8)), "b": {"c": torch.zeros((4,))}}
    opt = TA.init_opt(params, cfg)
    for _ in range(120):
        grads = {"a": 2 * (params["a"] - 3.0), "b": {"c": 2 * (params["b"]["c"] - 3.0)}}
        params, opt, _ = TA.apply_updates(params, grads, opt, cfg)
    loss = sum(float(((p - 3.0) ** 2).sum()) for p in tleaves(params))
    assert loss < 5e-2


# --------------------------------------------------------------- compression


def test_compress_grads_three_steps_match_reference():
    """Dequantized grads and residual within 1e-6 after 3 error-feedback
    steps (bf16 and integer grad leaves included)."""
    tree = {"w": np.zeros((16, 8), np.float32), "h": np.zeros((5,), BF16),
            "i": np.zeros((3,), np.int32)}
    jr, tr = JCMP.init_residual(jax.tree.map(jnp.asarray, tree)), TCMP.init_residual(t(tree))
    for k in range(3):
        g = _grads(tree, k)
        jq, jr = JCMP.compress_grads(jax.tree.map(jnp.asarray, g), jr)
        tq, tr = TCMP.compress_grads(t(g), tr)
        for a, b in zip(tleaves((tq, tr)), jax.tree.leaves((jq, jr))):
            assert np_of(a).dtype == np_of(b).dtype
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(5).standard_normal(50).astype(np.float32)
    jq, js = JCMP.quantize_int8(jnp.asarray(x))
    tq, ts = TCMP.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(TCMP.dequantize_int8(tq, ts).numpy(),
                               np.asarray(JCMP.dequantize_int8(jq, js)), rtol=1e-7)


# --------------------------------------------------------------- sparse backward


def _dense(browind, bcolind, bvalues, d_out, d_in):
    nb, r, c = bvalues.shape
    w = np.zeros((d_out // r, d_in // c, r, c), bvalues.dtype)
    w[browind, bcolind] = bvalues
    return w.transpose(0, 2, 1, 3).reshape(d_out, d_in)


@pytest.mark.parametrize("block,d_in,d_out", [((8, 16), 64, 128), ((8, 16), 128, 48),
                                              ((8, 128), 256, 64), ((8, 128), 384, 256)])
def test_transposed_stream_is_the_transposed_matrix(block, d_in, d_out):
    p = JL.sparse_linear_init(jax.random.PRNGKey(0), d_in, d_out, 0.5, block,
                              jnp.float32)
    browind, bcolind, vals = (to_tensor(p[k]) for k in ("browind", "bcolind", "bvalues"))
    perm, tr, tc, tptr = transposed_stream(browind, bcolind, d_in // block[1])
    assert all(a.dtype == torch.int32 for a in (perm, tr, tc, tptr))
    assert bool((tr[1:] >= tr[:-1]).all())  # sorted by block-row of Wᵀ
    assert tptr.shape == (d_in // block[1] + 1,) and int(tptr[-1]) == len(browind)
    np.testing.assert_array_equal(np.diff(tptr.numpy()),
                                  np.bincount(tr.numpy(), minlength=d_in // block[1]))
    tv = transposed_values(vals, perm)
    assert tv.shape == (len(perm), block[1], block[0]) and tv.is_contiguous()
    np.testing.assert_array_equal(
        _dense(tr.numpy(), tc.numpy(), tv.numpy(), d_in, d_out),
        _dense(browind.numpy(), bcolind.numpy(), vals.numpy(), d_out, d_in).T)
    # stacked streams: one row per layer
    stacked = transposed_stream(torch.stack([browind] * 3), torch.stack([bcolind] * 3),
                                d_in // block[1])
    for one, three in zip((perm, tr, tc, tptr), stacked):
        assert three.shape == (3,) + tuple(one.shape) and torch.equal(three[2], one)


def _layer_inputs(block, d_in, d_out, T, integer, seed=0):
    rng = np.random.default_rng(seed)
    p = JL.sparse_linear_init(jax.random.PRNGKey(seed), d_in, d_out, 0.5, block,
                              jnp.float32)
    p = jax.tree.map(np.asarray, p)
    if integer:
        p["bvalues"] = rng.integers(-2, 3, p["bvalues"].shape).astype(np.float32)
        x = rng.integers(-2, 3, (T, d_in)).astype(np.float32)
        gy = rng.integers(-2, 3, (T, d_out)).astype(np.float32)
    else:
        x = rng.standard_normal((T, d_in)).astype(np.float32)
        gy = rng.standard_normal((T, d_out)).astype(np.float32)
    return p, x, gy


def _jax_grads(p, x, gy, d_out):
    def f(bv, xx):
        return JL.sparse_linear_apply(dict(p, bvalues=bv), xx, d_out)

    y, vjp = jax.vjp(f, jnp.asarray(p["bvalues"]), jnp.asarray(x))
    gbv, gx = vjp(jnp.asarray(gy))
    return np.asarray(y), np.asarray(gbv), np.asarray(gx)


def _port_grads(p, x, gy, d_out):
    tp = TL.with_transpose(TL.with_row_pointer(t(p), d_out), x.shape[1])
    bv = tp["bvalues"].clone().requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    y = TL.sparse_linear_apply(dict(tp, bvalues=bv), xx, d_out)
    y.backward(torch.from_numpy(gy))
    return y.detach().numpy(), bv.grad.numpy(), xx.grad.numpy()


@pytest.mark.parametrize("T", [1, 4, 64])
@pytest.mark.parametrize("block,d_in,d_out", [((8, 16), 64, 128), ((8, 16), 128, 64),
                                              ((8, 128), 256, 128), ((8, 128), 128, 256)])
def test_sparse_backward_matches_jax_grad(block, d_in, d_out, T):
    """grad x and grad bvalues within 1e-5 of the leaf's max |g| (f32 sums
    over T or over a block-row in another order)."""
    p, x, gy = _layer_inputs(block, d_in, d_out, T, integer=False)
    jy, jgb, jgx = _jax_grads(p, x, gy, d_out)
    ty, tgb, tgx = _port_grads(p, x, gy, d_out)
    np.testing.assert_allclose(ty, jy, rtol=2e-4, atol=2e-4)
    for got, want in ((tgb, jgb), (tgx, jgx)):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("T", [1, 4, 64])
@pytest.mark.parametrize("block,d_in,d_out", [((8, 16), 64, 128), ((8, 128), 256, 128)])
def test_sparse_backward_bit_equal_on_integer_inputs(block, d_in, d_out, T):
    """Integer-valued values, x and gy: every f32 sum is exact, so both
    gradients equal the reference's bit for bit."""
    p, x, gy = _layer_inputs(block, d_in, d_out, T, integer=True, seed=1)
    _, jgb, jgx = _jax_grads(p, x, gy, d_out)
    _, tgb, tgx = _port_grads(p, x, gy, d_out)
    np.testing.assert_array_equal(tgb, jgb)
    np.testing.assert_array_equal(tgx, jgx)


def test_sparse_index_leaves_get_zero_gradients():
    p, x, gy = _layer_inputs((8, 16), 64, 128, 4, integer=False)
    tp = TL.with_transpose(TL.with_row_pointer(t(p), 128), 64)
    gyt = torch.from_numpy(gy)

    def loss(params, xx):
        return (TL.sparse_linear_apply(params, xx, 128) * gyt).sum()

    _, grads = TS.value_and_grad_trainable(loss)(tp, torch.from_numpy(x))
    assert set(grads) == set(tp)
    for key in ("browind", "bcolind", *TL.DERIVED):
        assert grads[key].dtype == torch.int32 and not grads[key].any(), key
    _, jgb, _ = _jax_grads(p, x, gy, 128)
    np.testing.assert_allclose(grads["bvalues"].numpy(), jgb, rtol=0,
                               atol=1e-5 * np.abs(jgb).max())


def test_strip_and_rebuild_derived_keys():
    jc = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), n_layers=2,
                             ffn_density=0.5, sparse_block=(8, 16))
    tc = port_cfg(jc)
    params = convert.lm_params(jax.tree.map(np.asarray, JLM.init_params(
        jax.random.PRNGKey(0), jc, jnp.float32)), tc)
    stripped = TL.strip_derived(params)
    w = stripped["blocks"]["b0"]["mlp"]["w_down"]
    assert set(w) == {"browind", "bcolind", "bvalues"}
    assert "browptr" in params["blocks"]["b0"]["mlp"]["w_down"]  # not in place
    rebuilt = TL.with_derived(stripped, tc)
    for a, b in zip(tleaves(rebuilt), tleaves(params)):
        assert torch.equal(a, b)
    dense = port_cfg(get_config("smollm-360m").reduced())
    assert TL.with_derived(stripped, dense) is stripped


# --------------------------------------------------------------- train step


def _cfgs(arch, sparse=False, n_layers=2):
    jc = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)
    if sparse:
        jc = dataclasses.replace(jc, ffn_density=0.5, sparse_block=(8, 16))
    return jc, port_cfg(jc)


def _batch(vocab, B=4, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}


def _state(jc, tc, dtype, opt_kw):
    params = JLM.init_params(jax.random.PRNGKey(0), jc, dtype)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), tc)
    jopt = JA.init_opt(params, JA.AdamWConfig(**opt_kw))
    topt = TA.init_opt(TL.strip_derived(tparams), TA.AdamWConfig(**opt_kw))
    return params, tparams, jopt, topt


OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
STEP_CASES = [("smollm-360m", False, 1), ("qwen1.5-0.5b", True, 1),
              ("smollm-360m", False, 2), ("qwen1.5-0.5b", True, 2)]


@pytest.mark.parametrize("arch,sparse,microbatches", STEP_CASES)
def test_train_step_matches_reference(arch, sparse, microbatches):
    """f32 params: the loss within 1e-5 relative; every grad leaf within
    1e-4 of its max |g|; updated params within 1e-5 wherever |g| > 1e-3 ·
    max |g| (at step 1 AdamW moves a parameter by about ±lr·sign(g), so a
    near-zero grad whose sign flips is a 2·lr difference that says
    nothing)."""
    jc, tc = _cfgs(arch, sparse)
    params, tparams, jopt, topt = _state(jc, tc, jnp.float32, OPT)
    jb, tb = _batch(jc.vocab)
    jloss, jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                        static_argnums=2)(params, jb, jc)
    tloss, tg = TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jgl, tgl = jax.tree.leaves(jg), tleaves(TL.strip_derived(tg))
    assert len(jgl) == len(tgl)
    for a, b in zip(tgl, jgl):
        b = np.asarray(b)
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))
    jp, jo, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**OPT),
                                            microbatches))(params, jopt, jb)
    tp, to, tm = TS.make_train_step(tc, TA.AdamWConfig(**OPT), microbatches)(
        tparams, topt, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(to.step) == 1
    for key in TL.DERIVED if sparse else ():
        assert tp["blocks"]["b0"]["mlp"]["w_gate"][key] is \
            tparams["blocks"]["b0"]["mlp"]["w_gate"][key]
    for a, b, g in zip(tleaves(TL.strip_derived(tp)), jax.tree.leaves(jp), jgl):
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(g))
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,sparse", [("smollm-360m", False), ("qwen1.5-0.5b", True)])
def test_bf16_train_step_loss_matches_reference(arch, sparse):
    """bf16 params: the loss within 1e-2 relative (bf16 rounds at other
    places in the two frameworks)."""
    jc, tc = _cfgs(arch, sparse)
    params, tparams, jopt, topt = _state(jc, tc, jnp.bfloat16, OPT)
    jb, tb = _batch(jc.vocab, seed=1)
    _, _, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**OPT)))(params, jopt, jb)
    tp, _, tm = TS.make_train_step(tc, TA.AdamWConfig(**OPT))(tparams, topt, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-2)
    assert tp["embed"]["emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("sparse", [False, True])
def test_remat_full_and_none_are_bit_equal(sparse):
    jc, tc = _cfgs("qwen1.5-0.5b", sparse, n_layers=3)
    _, tparams, _, _ = _state(jc, tc, jnp.float32, OPT)
    _, tb = _batch(jc.vocab, seed=2)
    vag = TS.value_and_grad_trainable(TLM.loss_fn)
    out = {mode: vag(tparams, tb, dataclasses.replace(tc, remat=mode))
           for mode in ("full", "dots", "none")}
    for mode in ("dots", "none"):
        assert torch.equal(out["full"][0], out[mode][0])
        for a, b in zip(tleaves(out["full"][1]), tleaves(out[mode][1])):
            assert torch.equal(a, b)


def test_loss_fn_raises_for_what_is_not_ported():
    """Nothing on the loss's path raises any more: remat="dots" runs under
    autograd (item 8, ported) and without it, as do the encoder (a qwen
    with an ``encoder`` subtree, fed ``frames``) and multi-token prediction
    (an ``mtp`` subtree)."""
    _, tc = _cfgs("qwen1.5-0.5b")
    _, tparams, _, _ = _state(*_cfgs("qwen1.5-0.5b"), jnp.float32, OPT)
    _, tb = _batch(tc.vocab)
    enc_cfg = dataclasses.replace(tc, encoder_layers=1)
    enc_params = TLM.init_params(torch.Generator().manual_seed(0), enc_cfg,
                                 torch.float32)
    frames = torch.randn((4, 24, tc.d_model), generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(TLM.loss_fn(enc_params, dict(tb, frames=frames), enc_cfg))
    mtp_cfg = dataclasses.replace(tc, mtp_depth=1)
    mtp_params = TLM.init_params(torch.Generator().manual_seed(0), mtp_cfg,
                                 torch.float32)
    assert torch.isfinite(TLM.loss_fn(mtp_params, tb, mtp_cfg))
    dots = dataclasses.replace(tc, remat="dots")
    loss, grads = TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb, dots)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tleaves(grads))
    with torch.no_grad():  # no autograd: nothing to rematerialize
        assert torch.equal(TLM.loss_fn(tparams, tb, dots), loss)


def _moe_cfgs(arch, sparse=False):
    """The reduced MoE archs: mixtral at 2 layers, deepseek at its reduced 4
    (3 dense MLA prefix layers, 1 MLA + MoE repeat, the MTP block)."""
    if arch == "mixtral-8x22b":
        return _cfgs(arch, sparse)
    jc = get_config(arch).reduced()
    if sparse:
        jc = dataclasses.replace(jc, ffn_density=0.5, sparse_block=(8, 16))
    return jc, port_cfg(jc)


@pytest.mark.parametrize("arch,sparse", [("deepseek-v3-671b", False),
                                         ("deepseek-v3-671b", True),
                                         ("mixtral-8x22b", False)])
def test_loss_fn_with_mtp_matches_reference(arch, sparse):
    """The MoE family's loss through ``jax.value_and_grad`` and autograd, f32:
    deepseek's includes 0.3 times the MTP loss (its MLA block, the sparse
    FFN where ``sparse``).  The loss within 1e-6 relative; every grad leaf
    within 1e-5 of its max |g| (MLA's f32 sums over the latent and head
    axes in another order reach 2.4e-6; zeros where JAX gives zeros: the
    router bias only selects)."""
    jc, tc = _moe_cfgs(arch, sparse)
    params = JLM.init_params(jax.random.PRNGKey(3), jc, jnp.float32)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), tc)
    jb, tb = _batch(jc.vocab, B=2, S=20, seed=4)
    jloss, jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                        static_argnums=2)(params, jb, jc)
    tloss, tg = TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    if jc.mtp_depth:
        plain = JLM.loss_fn(params, jb, dataclasses.replace(jc, mtp_depth=0))
        assert abs(float(jloss) - float(plain)) > 1e-3  # the MTP term counts
    jgl = jax.tree_util.tree_flatten_with_path(jg)[0]
    tgl = tleaves(TL.strip_derived(tg))
    assert len(jgl) == len(tgl)
    for (path, b), a in zip(jgl, tgl):
        b = np.asarray(b)
        if b.dtype.kind != "f":
            continue
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_train_step_matches_reference(arch):
    """One jitted JAX train step against the port's (f32, AdamW): the loss
    within 1e-5 relative, updated params within 1e-5 wherever |g| > 1e-3 ·
    max |g| (test_train_step_matches_reference's bounds)."""
    jc, tc = _moe_cfgs(arch)
    params, tparams, jopt, topt = _state(jc, tc, jnp.float32, OPT)
    jb, tb = _batch(jc.vocab, B=2, S=20, seed=5)
    _, jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                    static_argnums=2)(params, jb, jc)
    jp, _, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**OPT)))(params, jopt, jb)
    tp, to, tm = TS.make_train_step(tc, TA.AdamWConfig(**OPT))(tparams, topt, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(to.step) == 1
    for a, b, g in zip(tleaves(TL.strip_derived(tp)), jax.tree.leaves(jp),
                       jax.tree.leaves(jg)):
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(g))
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        big = g > 1e-3 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-5)


def test_loss_fn_drops_the_modality_prefix():
    """llava: prefix_embeds ride in the batch; the loss reads the text
    positions only, within 1e-5 of the reference."""
    jc, tc = _cfgs("llava-next-34b")
    params = JLM.init_params(jax.random.PRNGKey(0), jc, jnp.float32)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), tc)
    jb, tb = _batch(jc.vocab, B=2, S=12)
    pe = np.random.default_rng(3).standard_normal(
        (2, jc.modality_tokens, jc.d_model)).astype(np.float32)
    want = JLM.loss_fn(params, dict(jb, prefix_embeds=jnp.asarray(pe)), jc)
    got = TLM.loss_fn(tparams, dict(tb, prefix_embeds=torch.from_numpy(pe)), tc)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
