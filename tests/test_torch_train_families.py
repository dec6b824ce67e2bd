"""Training of the MoE and linear-attention families against the JAX package.

The same inputs, made with numpy from a seed, go through ``jax.grad`` /
``jax.value_and_grad`` (or the jitted reference train step) and the port's
autograd (or its train step); JAX params cross by ``convert.lm_params``.
No Pallas kernel is on these paths: the reference's linear attention, MoE
and MLA are plain ``jnp``.  Tolerances, each stated where it is used:

* a layer's gradients within 2e-5 of each leaf's largest |g| (float32
  sums over tokens, chunks and heads in another order; measured 1.9e-6),
  the weighted sum it differentiates within 1e-4 relative (its random
  weights cancel: measured 2.3e-5);
* a model's loss within 1e-6 relative and every grad leaf within what
  the port's own grads move by under a 1e-7 relative perturbation of its
  params (MODEL_CASES);
* a train step's loss within 1e-5 relative and its updated params within
  1e-5 wherever |g| > 1e-3 max |g| (tests/test_torch_train_step.py's
  bounds: at step 1 AdamW moves a parameter by about ±lr·sign(g));
* bit-equality wherever the port compares with itself (the three remat
  policies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import steps as JS
from repro.models import linear_attn as JLA
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.formats import to_tensor
from repro_torch.launch import steps as TS
from repro_torch.models import linear_attn as TLA
from repro_torch.models import lm as TLM
from repro_torch.models.common import map_params
from repro_torch.optim import adamw as TA
from repro_torch.sparse import layers as TL
from repro_torch.tree import leaves as tleaves

LAYER_GRAD_TOL = 2e-5  # of each leaf's max |g|; measured 1.9e-6
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def configs(arch, **changes):
    jc = dataclasses.replace(get_config(arch).reduced(), **changes)
    return jc, tconfigs.ArchConfig(**dataclasses.asdict(jc))


def jtree(tree):
    return jax.tree.map(np.asarray, tree)


def keyed(tree) -> dict:
    """{path: leaf} of a param tree of either package."""
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(got, want, tol):
    """Every float leaf of ``got`` (tensors) within ``tol`` of its max |g|
    in ``want`` (jax arrays), leaf by leaf and key by key."""
    got, want = keyed(got), keyed(want)
    assert got.keys() == want.keys()
    for key, b in want.items():
        b = np.asarray(b)
        if b.dtype.kind != "f" or not b.size:
            continue
        a = got[key].detach().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                                   err_msg=key)


def weights(rng, shapes):
    """Random cotangent weights, one per output, as (jax, torch) pairs."""
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]


def weighted(outs, ws, lib):
    """sum_i <out_i, w_i>: a scalar whose gradient reaches every output."""
    return sum(lib.sum(o.astype(jnp.float32) * w) if lib is jnp
               else torch.sum(o.float() * w) for o, w in zip(outs, ws))


def torch_grads(fn, args):
    """Autograd of the scalar ``fn(*args)`` with respect to every float
    leaf of ``args`` (a tuple of tensors and param trees)."""
    flat = [map_params(lambda a: a.clone().requires_grad_(), x) for x in args]
    out = fn(*flat)
    leaves_ = [leaf for x in flat for leaf in (tleaves(x) if isinstance(x, dict)
                                               else [x])]
    gs = iter(torch.autograd.grad(out, leaves_))
    res = []
    for x in flat:
        if isinstance(x, dict):
            res.append(map_params(lambda a: next(gs), x))
        else:
            res.append(next(gs))
    return out.detach(), res


# ------------------------------------------------------------- §0: ties


def _tie_case(case):
    """(jax fn, torch fn, numpy args) whose inputs put the reference's
    ``jnp.maximum`` / ``jnp.minimum`` exactly at a tie: integer-valued
    inputs, whose products and sums are exact where the tie is decided."""
    rng = np.random.default_rng(30)
    if case == "gla_step-normalizer":
        # q . n = 1 exactly in every head: a tie of max(|q . n|, 1)
        B_, H, dk, dv = 2, 3, 4, 5
        q = np.zeros((B_, 1, H, dk), np.float32)
        q[..., 0] = 1.0
        k = np.zeros((B_, 1, H, dk), np.float32)
        k[..., 0] = 1.0
        v = rng.integers(-2, 3, (B_, 1, H, dv)).astype(np.float32)
        s = rng.integers(-2, 3, (B_, H, dk, dv)).astype(np.float32)
        n = np.zeros((B_, H, dk), np.float32)
        log_a = np.zeros((B_, 1, H), np.float32)
        w = rng.standard_normal((B_, 1, H, dv)).astype(np.float32)

        def jfn(q, k, v, s, n):
            y, st = JLA.gla_step(JLA.RecurrentState(s, n), q, k, v,
                                 jnp.asarray(log_a), normalize=True)
            return jnp.sum(y * w) + jnp.sum(st.n)

        def tfn(q, k, v, s, n):
            y, st = TLA.gla_step(TLA.RecurrentState(s, n), q, k, v,
                                 torch.from_numpy(log_a), normalize=True)
            return torch.sum(y * torch.from_numpy(w)) + torch.sum(st.n)

        return jfn, tfn, (q, k, v, s, n)
    if case in ("gla_chunked-decay", "gla_chunked-normalizer"):
        # log_a = 0 at every other step: decay = cum_i - cum_j = 0 below
        # the diagonal, a tie of min(decay, 0); integer q and k make many
        # |n_inter + n_intra| exactly 1
        B_, S_, H, dk, dv = 1, 16, 2, 3, 2
        q = rng.integers(-1, 2, (B_, S_, H, dk)).astype(np.float32)
        k = rng.integers(-1, 2, (B_, S_, H, dk)).astype(np.float32)
        v = rng.integers(-2, 3, (B_, S_, H, dv)).astype(np.float32)
        log_a = -rng.integers(0, 2, (B_, S_, H)).astype(np.float32)
        log_a[:, ::2] = 0.0
        w = rng.standard_normal((B_, S_, H, dv)).astype(np.float32)
        normalize = case.endswith("normalizer")

        def jfn(q, k, v, log_a):
            y, _ = JLA.gla_chunked(q, k, v, log_a, chunk=8, normalize=normalize)
            return jnp.sum(y * w)

        def tfn(q, k, v, log_a):
            y, _ = TLA.gla_chunked(q, k, v, log_a, chunk=8, normalize=normalize)
            return torch.sum(y * torch.from_numpy(w))

        return jfn, tfn, (q, k, v, log_a)
    jc, tc = configs("xlstm-1.3b")
    x = rng.integers(-1, 2, (2, 8, jc.d_model)).astype(np.float32)
    if case == "mlstm-input-gate":
        # w_ig = 0: the input gate is exactly 0, a tie of min(ig, 0)
        p = jtree(JLA.mlstm_init(jax.random.PRNGKey(31), jc, jnp.float32))
        p = map_params(np.array, p)
        p["w_ig"]["w"] = np.zeros_like(p["w_ig"]["w"])
        jname, tname = JLA.mlstm_apply, TLA.mlstm_apply
    else:
        # the i and f columns of w_in equal: z_i = z_f on the first step,
        # where m = max(z_f + 0, z_i) and n = max(n, 1) both tie
        p = jtree(JLA.slstm_init(jax.random.PRNGKey(32), jc, jnp.float32))
        w_in = np.array(p["w_in"]["w"]).reshape(jc.d_model, jc.n_heads, 4, -1)
        w_in[:, :, 1] = w_in[:, :, 0]
        p["w_in"]["w"] = w_in.reshape(jc.d_model, -1)
        jname, tname = JLA.slstm_apply, TLA.slstm_apply
    wy = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(p, x):
        return jnp.sum(jname(p, x, jc)[0] * wy)

    def tfn(p, x):
        return torch.sum(tname(p, x, tc)[0] * torch.from_numpy(wy))

    return jfn, tfn, (p, x)


TIE_CASES = ["gla_step-normalizer", "gla_chunked-decay", "gla_chunked-normalizer",
             "mlstm-input-gate", "slstm-normalizer"]


@pytest.mark.parametrize("case", TIE_CASES)
def test_tie_rule_matches_jax_grad(case):
    """At a tie of ``jnp.maximum`` / ``jnp.minimum`` against a constant JAX
    splits the gradient in halves; the port's ``torch.maximum`` /
    ``torch.minimum`` do the same (``torch.clamp`` passes all of it, which
    puts a tied term's gradient off by half).  The values within 1e-4
    relative (a weighted sum with cancellation), the gradients within 1e-5
    of their max (measured: 4.3e-7)."""
    jfn, tfn, args = _tie_case(case)
    jargs = jax.tree.map(jnp.asarray, args)
    targs = tuple(map_params(lambda x: torch.from_numpy(np.array(x)), a)
                  if isinstance(a, dict) else torch.from_numpy(a) for a in args)
    jval, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(*jargs)
    tval, tg = torch_grads(tfn, targs)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
    assert_grads_close(list(tg), list(jg), 1e-5)


# ------------------------------------------------------- layer gradients


GLA_CASES = [(16, 256), (48, 8)]  # one chunk of S, six chunks


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalized"])
@pytest.mark.parametrize("S_,chunk", GLA_CASES, ids=["one-chunk", "six-chunks"])
def test_gla_chunked_grads_match_jax_grad(normalize, S_, chunk):
    """Gradients of <y, w_y> + <s, w_s> + <n, w_n> with respect to q, k, v
    and the log decay, within 2e-5 of their max."""
    rng = np.random.default_rng(33)
    B_, H, dk, dv = 2, 3, 8, 6
    q, k = (rng.standard_normal((B_, S_, H, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B_, S_, H, dv)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((B_, S_, H))).astype(np.float32)
    jw, tw = weights(rng, [(B_, S_, H, dv), (B_, H, dk, dv), (B_, H, dk)])

    def jfn(*a):
        y, st = JLA.gla_chunked(*a, chunk=chunk, normalize=normalize)
        return weighted((y, st.s, st.n), jw, jnp)

    def tfn(*a):
        y, st = TLA.gla_chunked(*a, chunk=chunk, normalize=normalize)
        return weighted((y, st.s, st.n), tw, torch)

    args = (q, k, v, log_a)
    jval, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    tval, tg = torch_grads(tfn, tuple(map(torch.from_numpy, args)))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
    assert_grads_close(list(tg), list(jg), LAYER_GRAD_TOL)


LAYERS = {"mamba2": "zamba2-2.7b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("S_,chunk", [(24, 256), (32, 8)], ids=["one-chunk",
                                                                 "four-chunks"])
def test_layer_grads_match_jax_grad(name, S_, chunk):
    """``mamba2_apply`` / ``mlstm_apply`` / ``slstm_apply`` (f32): the
    gradients of <y, w_y> + <final state, w> with respect to every param
    and to x, within 2e-5 of each leaf's max.  sLSTM has no chunk: its
    per-token loop runs S steps under autograd."""
    jc, tc = configs(LAYERS[name])
    p = jtree(getattr(JLA, f"{name}_init")(jax.random.PRNGKey(34), jc, jnp.float32))
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, S_, jc.d_model)).astype(np.float32)
    kw = {} if name == "slstm" else {"chunk": chunk}
    jy, jst = getattr(JLA, f"{name}_apply")(jax.tree.map(jnp.asarray, p),
                                            jnp.asarray(x), jc, **kw)
    jw, tw = weights(rng, [jy.shape] + [s.shape for s in jst])

    def jfn(p, x):
        y, st = getattr(JLA, f"{name}_apply")(p, x, jc, **kw)
        return weighted((y,) + tuple(st), jw, jnp)

    def tfn(p, x):
        y, st = getattr(TLA, f"{name}_apply")(p, x, tc, **kw)
        return weighted((y,) + tuple(st), tw, torch)

    jval, jg = jax.value_and_grad(jfn, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                                       jnp.asarray(x))
    tval, tg = torch_grads(tfn, (map_params(torch.from_numpy, p), torch.from_numpy(x)))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
    assert_grads_close(list(tg), list(jg), LAYER_GRAD_TOL)


# ------------------------------------------------------- models and steps


# arch -> its cut for the CPU: zamba2 and xlstm at one repeat (5 Mamba2 +
# the shared block; 7 mLSTM + 1 sLSTM), deepseek at its 3 dense MLA prefix
# layers with no MoE repeat (plus the MTP block), mixtral at 2
FAMILY = {"zamba2-2.7b": dict(n_layers=6), "xlstm-1.3b": dict(n_layers=8),
          "deepseek-v3-671b": dict(n_layers=3), "mixtral-8x22b": dict(n_layers=2)}


def model(arch, seed=36, **changes):
    jc, tc = configs(arch, **dict(FAMILY[arch], **changes))
    params = JLM.init_params(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jc, tc, params, convert.lm_params(jtree(params), tc)


def batch(vocab, B=2, S=32, seed=37):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)})


def jax_value_and_grad(params, jb, jc):
    return jax.jit(JS._value_and_grad_trainable(JLM.loss_fn),
                   static_argnums=2)(params, jb, jc)


# (arch, sparse, n_layers, grad tolerance of each leaf's max): the
# tolerance is what the port's own grads move by when its params are
# perturbed by 1e-7 relative (measured: zamba2 at 6 layers 1.9e-5-5.6e-5,
# xlstm at 8 2.1e-5-2.3e-5, zamba2 at 12 2.9e-4-7.6e-4, deepseek at 3
# 3.1e-6-3.7e-6), so f32 sums in another order can move them as far
MODEL_CASES = [("zamba2-2.7b", False, 6, 1e-4), ("zamba2-2.7b", True, 6, 1e-4),
               ("zamba2-2.7b", False, 12, 2e-3), ("xlstm-1.3b", False, 8, 1e-4),
               ("deepseek-v3-671b", False, 3, 2e-5),
               ("deepseek-v3-671b", True, 3, 2e-5)]


@pytest.mark.parametrize("arch,sparse,n_layers,tol", MODEL_CASES)
def test_loss_and_grads_match_reference(arch, sparse, n_layers, tol):
    """``loss_fn`` under ``jax.value_and_grad`` and autograd (f32, remat
    full): the loss within 1e-6 relative, every grad leaf within ``tol`` of
    its max.  zamba2's shared block (unstacked) is invoked once a repeat:
    at 12 layers twice, and its gradient is the sum over both invocations,
    as JAX's is."""
    changes = dict(ffn_density=0.5, sparse_block=(8, 16)) if sparse else {}
    jc, tc, params, tparams = model(arch, n_layers=n_layers, **changes)
    jb, tb = batch(jc.vocab)
    jloss, jg = jax_value_and_grad(params, jb, jc)
    tloss, tg = TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert_grads_close(TL.strip_derived(tg), jg, tol)


def test_zamba2_12_layer_bound_is_the_references_own_sensitivity():
    """MODEL_CASES holds zamba2 at 12 layers to 2e-3 of each grad leaf's
    max, the port's own sensitivity.  The reference is as sensitive: its
    grads move 3.7e-4-5.1e-4 of their max when its params are perturbed by
    1e-7 relative (three draws; the port's own: 1.6e-4-7.5e-4), and the
    port sits 3.1e-4 from it.  So f32 sums in another order move the
    reference's grads as far as the port's, and the bound stands."""
    jc, _, params, _ = model("zamba2-2.7b", n_layers=12)
    jb, _ = batch(jc.vocab)
    vag = jax.jit(JS._value_and_grad_trainable(JLM.loss_fn), static_argnums=2)
    _, jg = vag(params, jb, jc)
    rng = np.random.default_rng(100)
    pert = jax.tree.map(lambda a: a * (1 + 1e-7 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype)), params)
    _, jg2 = vag(pert, jb, jc)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                      / max(float(np.abs(np.asarray(b)).max()), 1e-30))
                for a, b in zip(jax.tree.leaves(jg2), jax.tree.leaves(jg))
                if np.asarray(b).dtype.kind == "f" and np.asarray(b).size)
    tol = dict(((a, s_, n), t) for a, s_, n, t in MODEL_CASES)[
        ("zamba2-2.7b", False, 12)]
    assert 1e-4 <= moved <= tol, moved


def _assert_step_matches(tp, to, tm, jp, jo, jm, jg):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(to.step) == int(jo.step)
    for a, b, g in zip(tleaves(TL.strip_derived(tp)), jax.tree.leaves(jp),
                       jax.tree.leaves(jg)):
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(g))
        if a.dtype.kind != "f" or not a.size:
            np.testing.assert_array_equal(a, b)
            continue
        big = g > 1e-3 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-5)


INT8 = dict(quantized_m=True, quantized_v=True)
STEP_CASES = [("zamba2-2.7b", {}, 1, {}), ("xlstm-1.3b", {}, 1, {}),
              ("deepseek-v3-671b", INT8, 1, dict(n_layers=4)),
              ("mixtral-8x22b", {}, 2, {})]


@pytest.mark.parametrize("arch,opt_kw,microbatches,cut", STEP_CASES,
                         ids=["zamba2", "xlstm", "deepseek-int8-moments",
                              "mixtral-2-microbatches"])
def test_train_step_matches_reference(arch, opt_kw, microbatches, cut):
    """One ``make_train_step`` against the jitted reference step with the
    same ``AdamWConfig`` (deepseek with int8 moments, as the reference's
    dryrun configures it, at its reduced 4 layers: the reference's int8
    encoding raises on the empty MoE stack of the 3-layer cut; mixtral
    with 2 microbatches, as its ``train_4k`` cell): the loss within 1e-5
    relative, the grad norm within 1e-4, the updated params within 1e-5
    wherever |g| > 1e-3 max |g|; int8 moments within one quantization
    step and their scales within 1e-4."""
    jc, tc, params, tparams = model(arch, seed=38, **cut)
    cfg = dict(OPT, **opt_kw)
    jopt = JA.init_opt(params, JA.AdamWConfig(**cfg))
    topt = TA.init_opt(TL.strip_derived(tparams), TA.AdamWConfig(**cfg))
    jb, tb = batch(jc.vocab, B=4, seed=39)
    # the step's own gradient: an MoE layer's capacity follows the tokens
    # of each microbatch, so the microbatches' mean is not the batch's
    jg = jax.tree.map(lambda *g: sum(g) / microbatches, *(
        jax_value_and_grad(params, jax.tree.map(
            lambda a: a.reshape((microbatches, -1) + a.shape[1:])[i], jb), jc)[1]
        for i in range(microbatches)))
    jp, jo, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**cfg), microbatches))(
        params, jopt, jb)
    tp, to, tm = TS.make_train_step(tc, TA.AdamWConfig(**cfg), microbatches)(
        tparams, topt, tb)
    _assert_step_matches(tp, to, tm, jp, jo, jm, jg)
    if opt_kw.get("quantized_m"):
        for moment in ("m", "v"):
            for key, want in keyed(getattr(jo, moment)).items():
                got = keyed(getattr(to, moment))[key].numpy()
                want = np.asarray(want)
                if key.endswith("['q']"):
                    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-4)


# ------------------------------------------------------------- remat


REMAT_CASES = [("zamba2-2.7b", False), ("zamba2-2.7b", True), ("xlstm-1.3b", False),
               ("mixtral-8x22b", False)]


@pytest.mark.parametrize("arch,sparse", REMAT_CASES)
def test_remat_dots_matches_reference(arch, sparse):
    """``remat="dots"``: the loss within 1e-6 relative and the grads within
    1e-4 of each leaf's max (MODEL_CASES' bound at these cuts) of the
    reference's ``dots_with_no_batch_dims_saveable``, and bit-equal to the
    port's own ``full`` and ``none``."""
    changes = dict(ffn_density=0.5, sparse_block=(8, 16)) if sparse else {}
    jc, tc, params, tparams = model(arch, remat="dots", **changes)
    jb, tb = batch(jc.vocab, seed=40)
    jloss, jg = jax_value_and_grad(params, jb, jc)
    vag = TS.value_and_grad_trainable(TLM.loss_fn)
    out = {mode: vag(tparams, tb, dataclasses.replace(tc, remat=mode))
           for mode in ("dots", "full", "none")}
    tloss, tg = out["dots"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert_grads_close(TL.strip_derived(tg), jg, 1e-4)
    for mode in ("full", "none"):
        assert torch.equal(out[mode][0], tloss)
        for a, b in zip(tleaves(out[mode][1]), tleaves(tg)):
            assert torch.equal(a, b)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ``aten.mm`` / ``aten.bmm`` calls made under it."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_remat_dots_keeps_the_2d_products_and_recomputes_the_rest(arch):
    """Over a forward and backward, ``dots`` runs exactly as many ``mm`` as
    ``none`` (every 2-D product of a repeat saved, none run again), while
    ``full`` runs the repeats' products a second time; ``dots`` recomputes
    the batched products (``bmm``) as ``full`` does."""
    _, tc, _, tparams = model(arch)
    _, tb = batch(tc.vocab, seed=41)
    counts = {}
    for mode in ("none", "dots", "full"):
        counter = _OpCounter()
        with counter:
            TS.value_and_grad_trainable(TLM.loss_fn)(tparams, tb,
                                                     dataclasses.replace(tc, remat=mode))
        counts[mode] = counter.counts
    assert counts["dots"]["mm"] == counts["none"]["mm"] < counts["full"]["mm"]
    assert counts["dots"]["bmm"] == counts["full"]["bmm"] > counts["none"]["bmm"]


def test_int8_moments_take_an_empty_stack():
    """deepseek cut to its 3 dense MLA prefix layers (the card's cut) has
    an empty MoE stack.  The port's int8 encoding gives its moments the
    floor scale (the reference's raises); at step 1 AdamW reads the
    moments before encoding them, so the updated params match the
    reference's step with f32 moments (test_train_step_matches_reference's
    bounds), and the int8 moments decode within one quantization step of
    its f32 moments."""
    jc, tc, params, tparams = model("deepseek-v3-671b", seed=42)
    assert jc.n_repeats == 0
    jopt = JA.init_opt(params, JA.AdamWConfig(**OPT))
    topt = TA.init_opt(TL.strip_derived(tparams), TA.AdamWConfig(**OPT, **INT8))
    jb, tb = batch(jc.vocab, B=4, seed=43)
    _, jg = jax_value_and_grad(params, jb, jc)
    jp, jo, jm = jax.jit(JS.make_train_step(jc, JA.AdamWConfig(**OPT)))(params, jopt, jb)
    tp, to, tm = TS.make_train_step(tc, TA.AdamWConfig(**OPT, **INT8))(tparams, topt, tb)
    _assert_step_matches(tp, to, tm, jp, jo, jm, jg)
    for moment in ("m", "v"):
        got = keyed(getattr(to, moment))
        for key, want in keyed(getattr(jo, moment)).items():
            q, scale = got[key + "['q']"], got[key + "['scale']"]
            assert q.dtype == torch.int8 and tuple(q.shape) == np.shape(want)
            if not q.numel():
                assert float(scale) == np.float32(1e-12)
                continue
            np.testing.assert_allclose(q.float().numpy() * float(scale), np.asarray(want),
                                       rtol=1e-4, atol=float(scale))


@pytest.mark.parametrize("block", [None, 7], ids=["whole-leaves", "blocks"])
@pytest.mark.parametrize("opt_kw", [{}, INT8], ids=["f32-moments", "int8-moments"])
def test_donated_update_equals_the_functional_one(opt_kw, block, monkeypatch):
    """``apply_updates(donate=True)`` (TrainLoop's, as the reference's loop
    donates its state to the jitted step): the same values as the
    functional update to the bit, written into the given tensors; three
    steps on bf16 params with an integer leaf and an empty one, the leaves
    whole or (``block`` = 7 elements) clipped and updated a block at a
    time."""
    if block:
        monkeypatch.setattr(TA, "_BLOCK", block)
    rng = np.random.default_rng(44)
    cfg = TA.AdamWConfig(**OPT, **opt_kw)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
                .to(torch.bfloat16),
                "b": {"c": torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
                      "empty": torch.zeros((0, 3))},
                "idx": torch.arange(4, dtype=torch.int32)}

    params = tree()
    opt = TA.init_opt(params, cfg)
    mine = (map_params(torch.clone, params), TA.OptState(
        opt.step, map_params(torch.clone, opt.m), map_params(torch.clone, opt.v)))
    for _ in range(3):
        grads = map_params(lambda a: torch.from_numpy(rng.standard_normal(
            tuple(a.shape)).astype(np.float32)).to(a.dtype), params)
        params, opt, _ = TA.apply_updates(params, grads, opt, cfg)
        ptrs = [a.data_ptr() for a in tleaves((mine[0], mine[1].m, mine[1].v))
                if a.numel()]
        mine = TA.apply_updates(*mine[:1], grads, mine[1], cfg, donate=True)[:2]
        assert [a.data_ptr() for a in tleaves((mine[0], mine[1].m, mine[1].v))
                if a.numel()] == ptrs
    assert int(mine[1].step) == 3
    for a, b in zip(tleaves(mine), tleaves((params, opt))):
        assert torch.equal(a, b)


def test_flatten_keeps_no_leaf_alive_in_a_cycle():
    """``repro_torch.tree.flatten`` builds no reference cycle: once the
    caller drops the tree, its leaves and the unflatten function, every
    leaf is freed at once, with the garbage collector off."""
    import gc
    import weakref

    from repro_torch.tree import flatten

    tree = {"a": torch.zeros(10), "b": (torch.zeros(3), None, [torch.ones(2)]),
            "c": TA.OptState(torch.zeros(()), {"m": torch.zeros(4)}, None)}
    enabled = gc.isenabled()
    gc.disable()
    try:
        flat, unflatten = flatten(tree)
        refs = [weakref.ref(x) for x in flat]
        rebuilt = unflatten(x + 1 for x in flat)
        assert float(rebuilt["b"][2][0][0]) == 2.0 and type(rebuilt["c"]) is TA.OptState
        del tree, flat, unflatten, rebuilt
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_train_loop_steps_leave_nothing_for_the_collector():
    """Two ``TrainLoop`` steps of deepseek's 3-layer cut with the garbage
    collector off hold the same tensors after each: a step's grads die
    with the step (they piled up on the card when a cycle held them)."""
    import gc

    from repro_torch.launch import train as TTR

    _, tc = configs("deepseek-v3-671b", n_layers=3)
    loop = TTR.TrainLoop(tc, TA.AdamWConfig(**OPT), seq_len=16, global_batch=2,
                         device="cpu")
    loop.init_state()
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        counts = []
        for n in (1, 2, 3):
            loop.run(n, log_every=0)
            counts.append(sum(torch.is_tensor(o) for o in gc.get_objects()))
        assert counts[1] == counts[2], counts
    finally:
        if enabled:
            gc.enable()
