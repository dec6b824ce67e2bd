"""repro_torch.models.linear_attn and the hybrid / recurrent archs against the
JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
(``repro.models.linear_attn``, ``blocks``, ``lm``, ``launch.serve``; plain
``jnp``, no Pallas kernel) and the port's; JAX params cross by
``repro_torch.convert.lm_params`` (bf16 by bit view).  Tolerances, each
stated where it is used:

* float32 within rtol = atol = 2e-4, the port's tolerance for sums taken
  in another order (tests/test_torch_models.py);
* bfloat16 mLSTM bit for bit (its casts fall where the reference's do);
  bfloat16 Mamba2 within 2^-7 norm-wise (two bf16 ulps): XLA rounds
  ``silu``'s sigmoid to bf16 before its product, where ``F.silu`` rounds
  once, so the gate differs by an ulp in about half its elements;
* decode(prefill(S)) within 5e-3 of prefill(S+1), the bound of
  tests/test_archs.py:test_prefill_decode_consistency;
* greedy tokens equal.

Sparse zamba2 runs its shared block's FFN at ``ffn_density=0.5`` in (8, 16)
blocks (d_model 64 does not tile into (8, 128)), as
tests/test_torch_models.py does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.models import blocks as JB
from repro.models import linear_attn as JL
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.formats import to_tensor
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import linear_attn as TL
from repro_torch.models import lm as TLM
from repro_torch.models.common import map_params
from repro_torch.sparse.layers import DERIVED

from _torch_common import np_of

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_NORM_TOL = 2 ** -7  # two ulps of bf16's 8-bit significand, norm-wise
ARCHS = ["zamba2-2.7b", "xlstm-1.3b"]
MODELS = [("zamba2-2.7b", False), ("zamba2-2.7b", True), ("xlstm-1.3b", False)]
# block kind -> (arch whose reduced config it runs at, linear_attn name)
FNS = {"mamba": ("zamba2-2.7b", "mamba2"), "mlstm": ("xlstm-1.3b", "mlstm"),
       "slstm": ("xlstm-1.3b", "slstm")}
B, S, MAX_LEN = 2, 16, 32


def configs(arch, sparse=False):
    cfg = get_config(arch).reduced()
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


def close_states(got, want):
    """A port state against the reference's, leaf by leaf (float32)."""
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def randn(rng, shape, dtype=jnp.float32):
    """(jax array, tensor) of the same standard-normal values in ``dtype``."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype)
    return a, t(a)


# ------------------------------------------------------------------ GLA


def gla_inputs(seed, S_, H=3, dk=8, dv=6):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, S_, H, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, S_, H, dv)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((2, S_, H))).astype(np.float32)
    return q, k, v, log_a


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalized"])
@pytest.mark.parametrize("S_,chunk", [(16, 256), (24, 24), (64, 16), (48, 8)],
                         ids=["one-chunk-of-S", "one-chunk", "four-chunks",
                              "six-chunks"])
def test_gla_chunked(normalize, S_, chunk):
    ins = gla_inputs(0, S_)
    jy, js = JL.gla_chunked(*map(jnp.asarray, ins), chunk=chunk, normalize=normalize)
    ty, ts = TL.gla_chunked(*map(torch.from_numpy, ins), chunk=chunk,
                            normalize=normalize)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    close(ty, jy)
    close_states(ts, js)


def test_gla_chunked_needs_the_chunk_to_divide_the_sequence():
    ins = map(torch.from_numpy, gla_inputs(1, 24))
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        TL.gla_chunked(*ins, chunk=16)


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalized"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_step(normalize, dtype):
    """One step from a random state; the output in q's dtype."""
    rng = np.random.default_rng(2)
    q, k, v, log_a = gla_inputs(3, 1)
    s = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    n = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    jy, js = JL.gla_step(JL.RecurrentState(jnp.asarray(s), jnp.asarray(n)),
                         jq, jk, jv, jnp.asarray(log_a), normalize=normalize)
    ty, ts = TL.gla_step(TL.RecurrentState(torch.from_numpy(s), torch.from_numpy(n)),
                         t(jq), t(jk), t(jv), torch.from_numpy(log_a),
                         normalize=normalize)
    assert str(ty.dtype).endswith(dtype)
    if dtype == "float32":
        close(ty, jy)
    else:  # the f32 result rounded once to bf16 in both
        np.testing.assert_array_equal(np_of(ty), np_of(jy))
    close_states(ts, js)


def test_chunked_equals_stepped():
    """The chunked form (three chunks) against gla_step from the zero state
    S times: the inter-chunk recurrence is the sequential one."""
    q, k, v, log_a = map(torch.from_numpy, gla_inputs(4, 48))
    y, state = TL.gla_chunked(q, k, v, log_a, chunk=16, normalize=True)
    st = TL.RecurrentState(torch.zeros(2, 3, 8, 6), torch.zeros(2, 3, 8))
    ys = []
    for i in range(48):
        yi, st = TL.gla_step(st, q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                             log_a[:, i:i + 1], normalize=True)
        ys.append(yi)
    close(y, torch.cat(ys, 1))
    close(state.s, st.s)
    close(state.n, st.n)


def test_softplus_is_logaddexp():
    """The port's softplus (logaddexp(x, 0), the reference's formula) and
    ``F.softplus`` (the identity above 20) both agree with
    ``jax.nn.softplus`` within 2 ulps over [-100, 100], far past the dt
    pre-activations the init gives (standard normal over d_model inputs,
    scaled by 1/sqrt(d_model): |x| of a few units).  Below float32's
    smallest normal, 2^-126, XLA flushes to zero where torch keeps the
    subnormal."""
    xs = np.linspace(-100, 100, 200_001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    for got in (TL.softplus(torch.from_numpy(xs)), F.softplus(torch.from_numpy(xs))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2 * 2 ** -23,
                                   atol=2 ** -126)
    assert TL.softplus(torch.tensor([1e4])).item() == 1e4


# ------------------------------------------------------------------ blocks


def la_params(kind, dtype=jnp.float32, seed=5):
    arch, name = FNS[kind]
    jc, tc = configs(arch)
    p = getattr(JL, f"{name}_init")(jax.random.PRNGKey(seed), jc, dtype)
    return jc, tc, name, p, map_params(to_tensor, jtree(p))


@pytest.mark.parametrize("kind", sorted(FNS))
def test_init_tree_shapes_and_dtypes_match_reference(kind):
    """``*_init`` in bf16: the reference's keys, shapes and dtypes (Mamba2's
    ``a_log`` / ``d_skip`` and sLSTM's ``r`` stay float32)."""
    jc, tc, name, jp, _ = la_params(kind, jnp.bfloat16)
    tp = getattr(TL, f"{name}_init")(torch.Generator().manual_seed(0), tc,
                                     torch.bfloat16)
    jleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(tp)}
    assert tleaves.keys() == jleaves.keys()
    for key, want in jleaves.items():
        got = tleaves[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype)[6:] == str(want.dtype), key


@pytest.mark.parametrize("kind", sorted(FNS))
@pytest.mark.parametrize("S_,chunk", [(24, 256), (32, 8)], ids=["one-chunk",
                                                                 "four-chunks"])
def test_apply_matches_reference(kind, S_, chunk):
    jc, tc, name, jp, tp = la_params(kind)
    jx, tx = randn(np.random.default_rng(6), (B, S_, jc.d_model))
    kw = {} if kind == "slstm" else {"chunk": chunk}
    jy, js = getattr(JL, f"{name}_apply")(jp, jx, jc, **kw)
    ty, ts = getattr(TL, f"{name}_apply")(tp, tx, tc, **kw)
    close(ty, jy)
    close_states(ts, js)


@pytest.mark.parametrize("kind", sorted(FNS))
def test_decode_matches_reference(kind):
    """One token from a random state (the zero state's leaves, filled with
    normals; sLSTM's normalizer kept positive)."""
    jc, tc, name, jp, tp = la_params(kind, seed=7)
    rng = np.random.default_rng(8)
    zero = JB.init_cache(jc, kind, B, MAX_LEN, jnp.float32)
    leaves = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in zero]
    if kind == "slstm":
        leaves[1] = np.abs(leaves[1]) + 0.5
    jstate = type(zero)(*map(jnp.asarray, leaves))
    tstate = type(TB.init_cache(tc, kind, B, MAX_LEN))(*map(torch.from_numpy, leaves))
    jx, tx = randn(rng, (B, 1, jc.d_model))
    jy, js = getattr(JL, f"{name}_decode")(jp, jx, jstate, jc)
    ty, ts = getattr(TL, f"{name}_decode")(tp, tx, tstate, tc)
    close(ty, jy)
    close_states(ts, js)
    for a, b in zip(tstate, leaves):  # the state given is left as it was
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
@pytest.mark.parametrize("seed", [9, 10])
def test_apply_bf16(kind, seed):
    """bf16 params and x: mLSTM bit for bit; Mamba2 within 2^-7 norm-wise
    (the silu gate's rounding, module docstring).  States (float32) within
    the f32 tolerance."""
    jc, tc, name, jp, tp = la_params(kind, jnp.bfloat16, seed=seed)
    jx, tx = randn(np.random.default_rng(seed), (B, 32, jc.d_model), jnp.bfloat16)
    jy, js = getattr(JL, f"{name}_apply")(jp, jx, jc, chunk=8)
    ty, ts = getattr(TL, f"{name}_apply")(tp, tx, tc, chunk=8)
    assert ty.dtype == torch.bfloat16
    if kind == "mlstm":
        np.testing.assert_array_equal(np_of(ty), np_of(jy))
    else:
        got, want = ty.float().numpy(), np.asarray(jy, np.float32)
        assert np.linalg.norm(got - want) <= BF16_NORM_TOL * np.linalg.norm(want)
    close_states(ts, js)


KINDS = [("zamba2-2.7b", "mamba"), ("zamba2-2.7b", "shared_attn"),
         ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm")]


@pytest.mark.parametrize("arch,kind,sparse",
                         [(a, k, False) for a, k in KINDS]
                         + [("zamba2-2.7b", "shared_attn", True)])
def test_block_apply_and_decode(arch, kind, sparse):
    """Every new kind through ``block_apply`` then ``block_decode`` against
    its prefill cache grown to 32; sparse runs the shared block's FFN on
    the block-sparse layer (the recurrent kinds have no FFN)."""
    jc, tc = configs(arch, sparse)
    p = JB.block_init(jax.random.PRNGKey(11), jc, kind, jnp.float32)
    tp = convert.lm_params({"blocks": {}, "shared": jtree(p)}, tc)["shared"]
    assert set(tp) == set(p)
    rng = np.random.default_rng(12)
    jh, th = randn(rng, (B, 20, jc.d_model))
    jout, jc_ = JB.block_apply(p, jh, jc, kind)
    tout, tc_ = TB.block_apply(tp, th, tc, kind)
    close(tout, jout)
    jcache = JLM._grow_cache(jc_, jc, kind, MAX_LEN)
    tcache = TLM._grow_cache(tc_, tc, kind, MAX_LEN)
    if kind == "shared_attn":
        assert tcache.length == 20 and tuple(tcache.k.shape) == jcache.k.shape
        close(tcache.k, jcache.k)
    else:
        assert tcache is tc_  # O(1): returned as it is
        close_states(tcache, jcache)
    jh1, th1 = randn(rng, (B, 1, jc.d_model))
    jout, jnew = JB.block_decode(p, jh1, jcache, jc, kind)
    tout, tnew = TB.block_decode(tp, th1, tcache, tc, kind)
    close(tout, jout)
    if kind == "shared_attn":
        assert tnew.length == 21 and tnew.k is tcache.k  # stepped in place
        close(tnew.v, jnew.v)
    else:
        close_states(tnew, jnew)


@pytest.mark.parametrize("arch,kind", KINDS)
def test_init_cache_matches_reference(arch, kind):
    jc, tc = configs(arch)
    want = JB.init_cache(jc, kind, 3, 40, jnp.float32)
    got = TB.init_cache(tc, kind, 3, 40, torch.float32)
    assert type(got).__name__ == type(want).__name__
    tensors = got[:-1] if kind == "shared_attn" else got
    for a, b in zip(tensors, want):
        assert tuple(a.shape) == b.shape and not a.any()
        assert a.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference(arch):
    """Every pattern entry's stacked caches, zamba2's shared block's too:
    one (NR, ...) KV cache per invocation."""
    jc, tc = configs(arch)
    want = JLM.init_caches(jc, 3, 40, jnp.bfloat16)
    got = TLM.init_caches(tc, 3, 40)
    assert got.blocks.keys() == want.blocks.keys()
    for key, c in got.blocks.items():
        w = want.blocks[key]
        assert type(c).__name__ == type(w).__name__
        tensors = c[:-1] if hasattr(c, "length") else c
        for a, b in zip(tensors, w):
            assert tuple(a.shape) == b.shape and a.shape[0] == jc.n_repeats
            assert str(a.dtype)[6:] == str(b.dtype), key


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module", params=MODELS,
                ids=lambda p: f"{p[0]}-{'sparse' if p[1] else 'dense'}")
def model(request):
    """(JAX cfg, port cfg, JAX params, port params, tokens) for one arch."""
    arch, sparse = request.param
    jc, tc = configs(arch, sparse)
    params = JLM.init_params(jax.random.PRNGKey(13), jc, jnp.float32)
    tparams = convert.lm_params(jtree(params), tc)
    toks = np.random.default_rng(14).integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    return jc, tc, params, tparams, toks


def test_param_tree_matches_reference(model):
    """The reference's tree, zamba2's unstacked ``shared`` block included
    (and no stacked entry for it); sparse adds only ``DERIVED``, in the
    shared block's FFN too.  The port's own init builds the same tree."""
    jc, tc, params, tparams, _ = model
    jkeys = {jax.tree_util.keystr(p): np.shape(v) for p, v in
             jax.tree_util.tree_leaves_with_path(params)}
    tkeys = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_leaves_with_path(tparams)}
    extra = tkeys.keys() - jkeys.keys()
    assert all(tkeys[k] == v for k, v in jkeys.items())
    assert ("shared" in tparams) == ("shared_attn" in jc.block_pattern)
    assert len(tparams["blocks"]) == len([k for k in jc.block_pattern
                                          if k != "shared_attn"])
    if jc.ffn_density < 1:
        assert {k[k.rindex("['") + 2:-2] for k in extra} == set(DERIVED)
        assert all(k.startswith("['shared']['mlp']") for k in extra)
    else:
        assert not extra
    own = TLM.init_params(torch.Generator().manual_seed(0), tc, torch.float32)
    okeys = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_leaves_with_path(own)}
    assert okeys == tkeys


def test_sparse_shared_block_gains_every_derived_key():
    """``convert.lm_params`` of a sparse zamba2 rebuilds the port-only keys
    of its only FFN, the unstacked shared block's, with the row pointer of
    each projection's block-rows."""
    jc, tc = configs("zamba2-2.7b", sparse=True)
    params = JLM.init_params(jax.random.PRNGKey(15), jc, jnp.float32)
    shared = convert.lm_params(jtree(params), tc)["shared"]["mlp"]
    for name, d_out in (("w_gate", jc.d_ff), ("w_up", jc.d_ff),
                        ("w_down", jc.d_model)):
        assert set(DERIVED) <= set(shared[name]), name
        assert tuple(shared[name]["browptr"].shape) == (d_out // 8 + 1,)


def test_forward_matches_reference(model):
    jc, tc, params, tparams, toks = model
    jlog, jh = JLM.forward(params, jnp.asarray(toks), jc, remat=False)
    tlog, th = TLM.forward(tparams, torch.from_numpy(toks), tc)
    close(tlog, jlog)
    close(th, jh)


def test_loss_matches_reference(model):
    jc, tc, params, tparams, toks = model
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = JLM.loss_fn(params, jax.tree.map(jnp.asarray, batch), jc)
    with torch.no_grad():
        got = TLM.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                          tc)
    assert got.dtype == torch.float32
    close(got, want)


def test_prefill_and_decode_logits_match_reference(model):
    """prefill, then three decode steps, each fed the reference's greedy
    token; every cache leaf against the reference's after the prefill."""
    jc, tc, params, tparams, toks = model
    prompt, nxt = toks[:, :S], toks[:, S:]
    jl, jcache = JLM.prefill(params, jnp.asarray(prompt), jc, MAX_LEN)
    tl, tcache = TLM.prefill(tparams, torch.from_numpy(prompt), tc, MAX_LEN)
    close(tl, jl)
    assert tcache.blocks.keys() == jcache.blocks.keys()
    for key, c in tcache.blocks.items():
        tensors = c[:-1] if hasattr(c, "length") else c
        for a, b in zip(tensors, jcache.blocks[key]):
            assert tuple(a.shape) == b.shape
            close(a, b)
    for step in range(3):
        jl, jcache = JLM.decode_step(params, jnp.asarray(nxt), jcache, jc)
        tl, tcache = TLM.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for key, c in tcache.blocks.items():  # the states after three steps
        tensors = c[:-1] if hasattr(c, "length") else c
        for a, b in zip(tensors, jcache.blocks[key]):
            close(a, b)


def test_decode_steps_the_stacked_caches_in_place(model):
    """``decode_step`` writes each recurrent block's new state into the
    stacked tensors it was given and leaves their identity; attention
    caches gain one in length, recurrent states have none."""
    _, tc, _, tparams, toks = model
    with torch.no_grad():
        _, caches = TLM.prefill(tparams, torch.from_numpy(toks[:, :S]), tc, MAX_LEN)
        before = {key: [a.clone() for a in (c[:-1] if hasattr(c, "length") else c)]
                  for key, c in caches.blocks.items()}
        _, new = TLM.decode_step(tparams, torch.from_numpy(toks[:, S:]), caches, tc)
    for key, c in new.blocks.items():
        old = caches.blocks[key]
        if hasattr(c, "length"):
            assert c.length == old.length + 1 == S + 1 and c.k is old.k
        else:
            assert all(a is b for a, b in zip(c, old))
            assert any(not torch.equal(a, b) for a, b in zip(c, before[key]))


def test_prefill_decode_consistency(model):
    """decode(prefill(S)) last logits == prefill(S+1) last logits, at the
    tolerance of tests/test_archs.py:test_prefill_decode_consistency."""
    _, tc, _, tparams, toks = model
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        _, caches = TLM.prefill(tparams, tokens[:, :S], tc, MAX_LEN)
        got, _ = TLM.decode_step(tparams, tokens[:, S:], caches, tc)
        want, _ = TLM.prefill(tparams, tokens, tc, MAX_LEN)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_over_several_chunks_matches_reference(arch):
    """A 512-token forward: two chunks of 256 in every Mamba2 / mLSTM
    layer, 512 sLSTM steps."""
    jc, tc = configs(arch)
    params = JLM.init_params(jax.random.PRNGKey(16), jc, jnp.float32)
    tparams = convert.lm_params(jtree(params), tc)
    toks = np.random.default_rng(17).integers(0, jc.vocab, (1, 512)).astype(np.int32)
    jlog, _ = JLM.forward(params, jnp.asarray(toks), jc, remat=False)
    with torch.no_grad():
        tlog, _ = TLM.forward(tparams, torch.from_numpy(toks), tc)
    close(tlog, jlog)


@pytest.mark.parametrize("arch,sparse", MODELS)
def test_server_generate_equals_reference_server(arch, sparse):
    jc, tc = configs(arch, sparse)
    jsrv = jserve.Server(jc, make_local_mesh(), 24)
    jsrv.params = jax.tree.map(lambda a: a.astype(jnp.float32)
                               if jnp.issubdtype(a.dtype, jnp.floating) else a,
                               jsrv.params)
    tsrv = tserve.Server(tc, 24, device="cpu", dtype=torch.float32)
    tsrv.params = convert.lm_params(jtree(jsrv.params), tc)
    prompts = np.random.default_rng(18).integers(0, jc.vocab, (3, 12)).astype(np.int32)
    want = jsrv.generate(prompts, 10)
    got = tsrv.generate(prompts, 10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_serves_the_linear_attention_archs_on_the_cpu(capsys, arch):
    out = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert "generated (2, 4)" in capsys.readouterr().out


def test_slstm_stepped_drifts_from_chunked_only_through_the_input_gemm():
    """One full-width xlstm sLSTM layer, f32, random x (phase 17 (a)'s
    random case, at S = 64).  The reference's ``slstm_apply`` and its
    stepped ``slstm_decode`` agree bit for bit on the CPU: XLA's CPU dot
    gives a row the same sum whatever the row count.  The port's two paths
    share the cell (``_slstm_cell``); they differ only in the input GEMM,
    run at M = B*S and at M = B, which torch's GEMMs (oneDNN here, cuBLAS
    on the card) round differently.  Fed the same pre-activations the
    port's cell loop is ``slstm_apply`` bit for bit, and the GEMM's rows
    differ by rounding alone."""
    jc, tc = get_config("xlstm-1.3b"), tconfigs.get_config("xlstm-1.3b")
    B, S, d, H = 2, 64, jc.d_model, jc.n_heads
    p = TL.slstm_init(torch.Generator().manual_seed(17), tc, torch.float32)
    x = np.random.default_rng([0, 17]).standard_normal((B, S, d)).astype(np.float32)
    pj = map_params(lambda t: jnp.asarray(t.numpy()), p)
    y, st = jax.jit(lambda p, x: JL.slstm_apply(p, x, jc))(pj, jnp.asarray(x))
    dec = jax.jit(lambda p, x, s: JL.slstm_decode(p, x, s, jc))
    s, ys = JL.slstm_zero_state(B, jc), []
    for t in range(S):
        yt, s = dec(pj, jnp.asarray(x[:, t:t + 1]), s)
        ys.append(yt)
    np.testing.assert_array_equal(np.asarray(jnp.concatenate(ys, 1)), np.asarray(y))
    for a, b in zip(st, s):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    xt = torch.from_numpy(x)
    with torch.no_grad():
        ty, tst = TL.slstm_apply(p, xt, tc)
        pre = TL.dense_apply(p["w_in"], xt).reshape(B, S, H, 4 * (d // H))
        rows = torch.cat([TL.dense_apply(p["w_in"], xt[:, t:t + 1])
                          for t in range(S)], 1).reshape(pre.shape)
        state, hs = TL.slstm_zero_state(B, tc), []
        for t in range(S):
            state = TL._slstm_cell(p, state, pre[:, t])
            hs.append(state.h)
        fed = TL._xlstm_out(p, torch.stack(hs, 1), xt)
    assert torch.equal(fed, ty) and all(torch.equal(a, b) for a, b in zip(state, tst))
    # f32 sums of 2,048 products in another order: a few ulps of the row's
    # largest pre-activation (measured 6.4e-6 of 5.2)
    np.testing.assert_allclose(rows.numpy(), pre.numpy(), rtol=0,
                               atol=1e-5 * float(pre.abs().max()))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)
