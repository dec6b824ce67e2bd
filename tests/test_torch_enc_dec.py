"""The encoder-decoder (seamless-m4t-medium) against the JAX package:
``attention.cross_attn_apply``, ``lm.encode``, the ``cross_attn`` kind
through ``forward`` / ``loss_fn`` / ``prefill`` / ``decode_step`` with
``memory``, and ``launch.steps``' prefill, decode and train steps.

The same inputs, made with numpy from a seed, go through the JAX function
(plain ``jnp``: no Pallas kernel is on this path; the sparse FFN runs
``kref.bcoo_spmv_ref``) and the port's; JAX params cross by
``repro_torch.convert.lm_params`` (bf16 by bit view).  Tolerances, each
stated where it is used:

* float32 within rtol = atol = 2e-4, the port's tolerance for sums taken
  in another order (tests/test_torch_models.py);
* bfloat16 cross-attention bit for bit (its casts fall where the
  reference's do); a bfloat16 encode within 2^-6 norm-wise (four ulps of
  bf16's 8-bit significand): XLA rounds ``silu``'s sigmoid to bf16 before
  its product, where ``F.silu`` rounds once (tests/test_torch_linear_attn.py),
  which moves each layer's SwiGLU by up to 2^-8 norm-wise, and the second
  encoder layer carries the first's difference (7.1e-3 measured);
* decode(prefill(S)) within 5e-3 of prefill(S+1), the bound of
  tests/test_archs.py:test_prefill_decode_consistency;
* a loss within 1e-5 relative, every grad leaf within 1e-4 of its max
  (tests/test_torch_train_step.py).

Sparse seamless runs its FFNs (encoder and decoder) at ``ffn_density=0.5``
in (8, 16) blocks: the reduced width (d_model 64) does not tile into
(8, 128).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import lm as JLM
from repro.optim import adamw as JAdam
from repro.runtime import checkpoint as JCK
from repro.sparse import layers as JSL
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.formats import to_tensor
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import lm as TLM
from repro_torch.models.common import map_params
from repro_torch.optim import adamw as TAdam
from repro_torch.runtime import checkpoint as TCK
from repro_torch.sparse import layers as TSL
from repro_torch.tree import leaves as tleaves

from _torch_common import np_of

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_NORM_TOL = 2 ** -6
B, S, S_ENC, MAX_LEN = 2, 12, 10, 24
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def configs(sparse=False):
    cfg = get_config(ARCH).reduced()
    if sparse:
        cfg = dataclasses.replace(cfg, ffn_density=0.5, sparse_block=(8, 16))
    return cfg, tconfigs.ArchConfig(**dataclasses.asdict(cfg))


def jtree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return to_tensor(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def close_bf16(got, want):
    """bf16 results: the same dtype, within 2^-6 of the reference norm-wise."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.linalg.norm(g - w) <= BF16_NORM_TOL * np.linalg.norm(w)


def same_bits(got, want):
    assert np_of(got).dtype == np_of(want).dtype
    np.testing.assert_array_equal(np_of(got), np_of(want))


def randn(rng, shape, dtype=jnp.float32):
    """(jax array, tensor) of the same standard-normal values in ``dtype``."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype)
    return a, t(a)


# ------------------------------------------------------------------ cross attn


def _xattn(dtype, seed=0):
    jc, tc = configs()
    p = JA.gqa_init(jax.random.PRNGKey(seed), jc, dtype)
    return jc, tc, p, map_params(to_tensor, jtree(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_apply(dtype):
    """x (B, 7, d) over memory (B, 13, d): no mask, no RoPE, every query
    against every memory position."""
    jc, tc, p, tp = _xattn(jnp.dtype(dtype))
    rng = np.random.default_rng(1)
    jx, tx = randn(rng, (B, 7, jc.d_model), jnp.dtype(dtype))
    jm, tm = randn(rng, (B, 13, jc.d_model), jnp.dtype(dtype))
    want = JA.cross_attn_apply(p, jx, jm, jc)
    got = TA.cross_attn_apply(tp, tx, tm, tc)
    assert tuple(got.shape) == want.shape == (B, 7, jc.d_model)
    if dtype == "float32":
        assert got.dtype == torch.float32
        close(got, want)
    else:
        same_bits(got, want)


def test_cross_attn_apply_promotes_f32_memory_over_bf16_weights():
    """bf16 weights and x, f32 memory: K and V in f32 (``jnp``'s
    promotion), the output in x's bf16, bit for bit."""
    jc, tc, p, tp = _xattn(jnp.bfloat16, seed=2)
    rng = np.random.default_rng(3)
    jx, tx = randn(rng, (B, 5, jc.d_model), jnp.bfloat16)
    jm, tm = randn(rng, (B, 9, jc.d_model))
    want = JA.cross_attn_apply(p, jx, jm, jc)
    got = TA.cross_attn_apply(tp, tx, tm, tc)
    same_bits(got, want)


def test_cross_attn_reads_every_memory_position():
    """Changing the last memory position changes every query's output
    (no causal mask between decoder and memory positions)."""
    _, tc, _, tp = _xattn(jnp.float32, seed=4)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 6, tc.d_model)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((1, 8, tc.d_model)).astype(np.float32))
    a = TA.cross_attn_apply(tp, x, m, tc)
    m2 = m.clone()
    m2[:, -1] += 1.0
    b = TA.cross_attn_apply(tp, x, m2, tc)
    assert ((a - b).abs().amax(-1) > 0).all()


# ------------------------------------------------------------------ encode


ENCODE_CASES = [("float32", "float32", False), ("bfloat16", "float32", False),
                ("bfloat16", "bfloat16", False), ("bfloat16", "float32", True),
                ("float32", "float32", True)]


@pytest.mark.parametrize("params_dtype,frames_dtype,sparse", ENCODE_CASES)
def test_encode_matches_reference(params_dtype, frames_dtype, sparse):
    """``encode``'s dtype follows ``jnp``'s promotion (f32 frames over bf16
    params give f32 memory, bf16 frames bf16), its values the reference's:
    f32 results within 2e-4, bf16 within 2^-6 norm-wise."""
    jc, tc = configs(sparse)
    params = JLM.init_params(jax.random.PRNGKey(6), jc, jnp.dtype(params_dtype))
    tparams = convert.lm_params(jtree(params), tc)
    rng = np.random.default_rng(7)
    jf, tf = randn(rng, (B, S_ENC, jc.d_model), jnp.dtype(frames_dtype))
    want = JLM.encode(params, jf, jc)
    with torch.no_grad():
        got = TLM.encode(tparams, tf, tc)
    assert str(got.dtype).endswith(str(want.dtype))
    assert tuple(got.shape) == want.shape == (B, S_ENC, jc.d_model)
    if got.dtype == torch.float32:
        close(got, want)
    else:
        close_bf16(got, want)


def test_encoder_attention_is_not_causal():
    """A change in the last frame moves the encoder's output at the first
    position."""
    _, tc = configs()
    tp = TLM.init_params(torch.Generator().manual_seed(0), tc, torch.float32)
    f = torch.randn((1, S_ENC, tc.d_model), generator=torch.Generator().manual_seed(1))
    f2 = f.clone()
    f2[:, -1] += 1.0
    with torch.no_grad():
        a, b = TLM.encode(tp, f, tc), TLM.encode(tp, f2, tc)
    assert not torch.equal(a[:, 0], b[:, 0])


def test_encode_takes_the_chunked_path_past_the_threshold(monkeypatch):
    """Threshold 16 and chunk 8 in both packages: a 32-frame encode runs
    query-chunked and non-causal in every encoder layer, and agrees with
    the reference's chunked encode."""
    jc, tc = configs()
    params = JLM.init_params(jax.random.PRNGKey(8), jc, jnp.float32)
    tparams = convert.lm_params(jtree(params), tc)
    f = np.random.default_rng(9).standard_normal((1, 32, jc.d_model)).astype(np.float32)
    with torch.no_grad():
        unchunked = TLM.encode(tparams, t(f), tc)
    monkeypatch.setattr(JA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(JA, "Q_CHUNK", 8)
    monkeypatch.setitem(JA._sdpa_qchunked.__kwdefaults__, "q_chunk", 8)
    monkeypatch.setattr(TA, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(TA, "Q_CHUNK", 8)
    calls, real = [], TA._sdpa_qchunked
    monkeypatch.setattr(TA, "_sdpa_qchunked",
                        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw))
    want = JLM.encode(params, jnp.asarray(f), jc)
    with torch.no_grad():
        got = TLM.encode(tparams, t(f), tc)
    assert calls == [False] * jc.encoder_layers
    close(got, want)
    close(got, unchunked.numpy())


def test_sparse_linear_apply_promotes_like_the_reference():
    """bf16 blocks meeting f32 activations (the encoder on f32 frames): the
    reference sums in f32 without rounding x to bf16, casts y to the
    blocks' bf16 and back to x's f32; so does the port, bit for bit on
    integer-valued inputs."""
    jp = JSL.sparse_linear_init(jax.random.PRNGKey(10), 64, 128, 0.5, (8, 16),
                                jnp.bfloat16)
    tp = TSL.with_transpose(TSL.with_row_pointer(map_params(to_tensor, jtree(jp)),
                                                 128), 64)
    x = (np.random.default_rng(11).integers(-40, 41, (3, 5, 64)) / 8).astype(np.float32)
    want = JSL.sparse_linear_apply(jp, jnp.asarray(x), 128)
    got = TSL.sparse_linear_apply(tp, t(x), 128)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ models

MODELS = [False, True]


@pytest.fixture(scope="module", params=MODELS, ids=["dense", "sparse"])
def model(request):
    """(JAX cfg, port cfg, JAX params, port params, tokens, frames, JAX
    memory, port memory), f32."""
    jc, tc = configs(request.param)
    params = JLM.init_params(jax.random.PRNGKey(13), jc, jnp.float32)
    tparams = convert.lm_params(jtree(params), tc)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, S_ENC, jc.d_model)).astype(np.float32)
    jmem = JLM.encode(params, jnp.asarray(frames), jc)
    with torch.no_grad():
        tmem = TLM.encode(tparams, t(frames), tc)
    return jc, tc, params, tparams, toks, frames, jmem, tmem


def test_param_tree_matches_reference(model):
    """The reference's tree key for key (the ``encoder`` subtree and the
    decoder's ``ln_x`` / ``xattn`` included); sparse adds only the port's
    derived keys, in the encoder's FFNs as in the decoder's.  The port's
    own init builds the same tree, and its parameter count is
    ``cfg.n_params`` plus what that leaves out (``in_proj`` and the
    norms)."""
    jc, tc, params, tparams = model[:4]
    jkeys = {jax.tree_util.keystr(p): np.shape(v) for p, v in
             jax.tree_util.tree_leaves_with_path(params)}
    tkeys = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_leaves_with_path(tparams)}
    assert all(tkeys[k] == v for k, v in jkeys.items())
    extra = tkeys.keys() - jkeys.keys()
    if jc.ffn_density < 1:
        assert {k[k.rindex("['") + 2:-2] for k in extra} == set(TSL.DERIVED)
        assert {k.split("]")[0] for k in extra} == {"['blocks'", "['encoder'"}
    else:
        assert not extra
    assert set(tparams["blocks"]["b0"]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                            "mlp"}
    own = TLM.init_params(torch.Generator().manual_seed(0), tc, torch.float32)
    okeys = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_leaves_with_path(own)}
    assert okeys == tkeys
    float_numel = sum(v.numel() for v in tleaves(TSL.strip_derived(own))
                      if v.is_floating_point())
    d = tc.d_model
    norms = d * (1 + 2 * tc.encoder_layers + 3 * tc.n_layers + 1)
    assert float_numel == tc.n_params + d * d + norms


def test_with_derived_reaches_the_encoder():
    """``convert.lm_params`` of a sparse seamless rebuilds the port-only
    keys of every stacked encoder FFN projection, one block-row pointer a
    layer."""
    jc, tc = configs(sparse=True)
    params = JLM.init_params(jax.random.PRNGKey(15), jc, jnp.float32)
    enc = convert.lm_params(jtree(params), tc)["encoder"]["blocks"]["mlp"]
    for name, d_out in (("w_gate", jc.d_ff), ("w_up", jc.d_ff),
                        ("w_down", jc.d_model)):
        assert set(TSL.DERIVED) <= set(enc[name]), name
        assert tuple(enc[name]["browptr"].shape) == (jc.encoder_layers, d_out // 8 + 1)
    stripped = TSL.strip_derived(convert.lm_params(jtree(params), tc))
    assert not set(TSL.DERIVED) & set(stripped["encoder"]["blocks"]["mlp"]["w_up"])


def test_forward_matches_reference(model):
    jc, tc, params, tparams, toks, _, jmem, tmem = model
    jlog, jh = JLM.forward(params, jnp.asarray(toks), jc, memory=jmem, remat=False)
    with torch.no_grad():
        tlog, th = TLM.forward(tparams, torch.from_numpy(toks), tc, memory=tmem)
    close(tlog, jlog)
    close(th, jh)


def test_loss_matches_reference(model):
    """``loss_fn`` encodes ``batch["frames"]`` itself."""
    jc, tc, params, tparams, toks, frames, _, _ = model
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "frames": frames}
    want = JLM.loss_fn(params, jax.tree.map(jnp.asarray, batch), jc)
    with torch.no_grad():
        got = TLM.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                          tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_and_decode_logits_match_reference(model):
    """prefill, then three decode steps against the same memory, each fed
    the reference's greedy token; the self-attention caches against the
    reference's after the prefill and after the steps."""
    jc, tc, params, tparams, toks, _, jmem, tmem = model
    prompt, nxt = toks[:, :S], toks[:, S:]
    jl, jcache = JLM.prefill(params, jnp.asarray(prompt), jc, MAX_LEN, memory=jmem)
    with torch.no_grad():
        tl, tcache = TLM.prefill(tparams, torch.from_numpy(prompt), tc, MAX_LEN,
                                 memory=tmem)
    close(tl, jl)

    def same_caches():
        assert tcache.blocks.keys() == jcache.blocks.keys()
        for key, c in tcache.blocks.items():
            assert c.length == int(jcache.blocks[key].length[0])
            for a, b in zip(c[:-1], jcache.blocks[key][:-1]):
                assert tuple(a.shape) == b.shape
                close(a, b)

    same_caches()
    for step in range(3):
        jl, jcache = JLM.decode_step(params, jnp.asarray(nxt), jcache, jc, memory=jmem)
        with torch.no_grad():
            tl, tcache = TLM.decode_step(tparams, torch.from_numpy(nxt), tcache, tc,
                                         memory=tmem)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    same_caches()


def test_prefill_decode_consistency(model):
    """decode(prefill(S)) last logits == prefill(S+1) last logits with the
    same memory, at the tolerance of tests/test_archs.py."""
    _, tc, _, tparams, toks, _, _, tmem = model
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        _, caches = TLM.prefill(tparams, tokens[:, :S], tc, MAX_LEN, memory=tmem)
        got, _ = TLM.decode_step(tparams, tokens[:, S:], caches, tc, memory=tmem)
        want, _ = TLM.prefill(tparams, tokens, tc, MAX_LEN, memory=tmem)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


def test_value_and_grad_matches_jax(model):
    """``value_and_grad_trainable(loss_fn)`` against ``jax.value_and_grad``
    of the reference's: the loss within 1e-5 relative, every grad leaf
    (the encoder's, ``in_proj``'s and the cross-attention's included)
    within 1e-4 of its max |g|."""
    jc, tc, params, tparams, toks, frames, _, _ = model
    batch = {"tokens": toks, "labels": toks, "frames": frames}
    jloss, jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                        static_argnums=2)(params, jax.tree.map(jnp.asarray, batch), jc)
    tloss, tg = TS.value_and_grad_trainable(TLM.loss_fn)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jgl, tgl = jax.tree.leaves(jg), tleaves(TSL.strip_derived(tg))
    assert len(jgl) == len(tgl)
    for a, b in zip(tgl, jgl):
        b = np.asarray(b)
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))
    assert float(np.abs(np.asarray(jg["encoder"]["in_proj"]["w"])).max()) > 0


def test_prefill_and_decode_steps_match_reference(model):
    """``make_prefill_step(cfg, "prefill_32k")`` (encoding the frames, caches
    of 32,768) and ``make_decode_step``'s step with ``batch["memory"]``
    against the reference's steps; the prefill step equal to the bit to
    ``prefill(memory=encode(frames))`` at the same max_len."""
    jc, tc, params, tparams, toks, frames, _, _ = model
    prompt, nxt = toks[:, :S], toks[:, S:]
    jl, jcache = JS.make_prefill_step(jc, "prefill_32k")(
        params, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)})
    with torch.no_grad():
        tl, tcache = TS.make_prefill_step(tc, "prefill_32k")(
            tparams, {"tokens": torch.from_numpy(prompt), "frames": t(frames)})
        memory = TLM.encode(tparams, t(frames), tc)
        direct, _ = TLM.prefill(tparams, torch.from_numpy(prompt), tc, 32768,
                                memory=memory)
    assert torch.equal(tl, direct)
    close(tl, jl)
    assert tcache.blocks["b0"].k.shape[2] == jcache.blocks["b0"].k.shape[2] == 32768
    jmem = JLM.encode(params, jnp.asarray(frames), jc)
    jl, _ = JS.make_decode_step(jc, "decode_32k")(
        params, {"token": jnp.asarray(nxt), "caches": jcache, "memory": jmem})
    with torch.no_grad():
        tl, tnew = TS.make_decode_step(tc, "decode_32k")(
            tparams, {"token": torch.from_numpy(nxt), "caches": tcache,
                      "memory": memory})
    close(tl, jl)
    assert tnew.blocks["b0"].length == S + 1


@pytest.mark.parametrize("sparse,microbatches", [(False, 1), (True, 2)])
def test_train_step_with_frames_matches_reference(sparse, microbatches):
    """One ``make_train_step`` on a batch with frames (split in two
    microbatches, frames too, in the sparse case) against the jitted
    reference step: the loss within 1e-5 relative, the grad norm within
    1e-4, updated params within 1e-5 wherever |g| > 1e-3 max |g|
    (tests/test_torch_train_step.py's bounds)."""
    jc, tc = configs(sparse)
    params = JLM.init_params(jax.random.PRNGKey(16), jc, jnp.float32)
    tparams = convert.lm_params(jtree(params), tc)
    jopt = JAdam.init_opt(params, JAdam.AdamWConfig(**OPT))
    topt = TAdam.init_opt(TSL.strip_derived(tparams), TAdam.AdamWConfig(**OPT))
    rng = np.random.default_rng(17)
    toks = rng.integers(0, jc.vocab, (4, S)).astype(np.int32)
    frames = rng.standard_normal((4, S_ENC, jc.d_model)).astype(np.float32)
    batch = {"tokens": toks, "labels": toks, "frames": frames}
    jp, _, jm = jax.jit(JS.make_train_step(jc, JAdam.AdamWConfig(**OPT), microbatches))(
        params, jopt, jax.tree.map(jnp.asarray, batch))
    tp, to, tm = TS.make_train_step(tc, TAdam.AdamWConfig(**OPT), microbatches)(
        tparams, topt, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(to.step) == 1
    jg = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn), static_argnums=2)(
        params, jax.tree.map(jnp.asarray, batch), jc)[1]
    for a, b, g in zip(tleaves(TSL.strip_derived(tp)), jax.tree.leaves(jp),
                       jax.tree.leaves(jg)):
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(g))
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-5)
    if sparse:  # the encoder's derived keys ride along unchanged
        for key in TSL.DERIVED:
            assert tp["encoder"]["blocks"]["mlp"]["w_gate"][key] is \
                tparams["encoder"]["blocks"]["mlp"]["w_gate"][key]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_encoder_checkpoint_crosses_both_packages(tmp_path, direction):
    """bf16 params of a sparse seamless (the encoder's block-sparse FFNs
    included) saved by one package restore in the other bit for bit; the
    port's restored tree rebuilds its derived keys."""
    jc, tc = configs(sparse=True)
    params = JLM.init_params(jax.random.PRNGKey(18), jc, jnp.bfloat16)
    tparams = convert.lm_params(jtree(params), tc)
    if direction == "port_to_jax":
        TCK.save_checkpoint(str(tmp_path), 3, TSL.strip_derived(tparams))
        got, step = JCK.restore_checkpoint(
            str(tmp_path), JLM.init_params(jax.random.PRNGKey(19), jc, jnp.bfloat16))
        pairs = zip(jax.tree.leaves(got), jax.tree.leaves(params))
    else:
        JCK.save_checkpoint(str(tmp_path), 3, params)
        like = TSL.strip_derived(TLM.init_params(torch.Generator().manual_seed(1), tc))
        got, step = TCK.restore_checkpoint(str(tmp_path), like)
        rebuilt = TSL.with_derived(got, tc)
        enc = rebuilt["encoder"]["blocks"]["mlp"]["w_down"]
        assert torch.equal(enc["browptr"],
                           tparams["encoder"]["blocks"]["mlp"]["w_down"]["browptr"])
        pairs = zip(tleaves(got), jax.tree.leaves(params))
    assert step == 3
    for a, b in pairs:
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_array_equal(np_of(a), np_of(b))
