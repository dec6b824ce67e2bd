"""repro_torch.models.moe against the JAX package's ``repro.models.moe``.

The same inputs, made with numpy from a seed, go through both packages'
routers, dispatch, combine and ``moe_apply``; JAX params cross as numpy
arrays (bf16 by bit view).  Tolerances, each stated where it is used:

* routing: expert ids equal, gates within 1e-6 (f32 logits summed in
  another order);
* dispatch: every array equal, given the same (expert, gate) assignments;
* combine: equal on the same slot buffers (each token's contributions are
  summed in the reference's order, ascending expert id);
* ``moe_apply`` in f32 within rtol = atol = 2e-4 (the port's LM tolerance,
  tests/test_torch_lm_serve.py), in bf16 within 4 bf16 ulps of the
  output's scale (products rounded to bf16 at other places), routing
  equal in both;
* gradients of sum(y^2) within 1e-6 of each leaf's largest |g| (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as JM
from repro_torch import configs as tconfigs
from repro_torch.core.formats import to_tensor
from repro_torch.models import moe as TM
from repro_torch.models.common import map_params

from _torch_common import np_of

ROUTERS = ["mixtral", "deepseek"]
BF16_ULPS = 4 * 2 ** -8  # 4 ulps of bf16's 8-bit significand, relative


def cfgs(router="mixtral", cap_factor=8.0, shared=0, **kw):
    """The reduced mixtral MoE (4 experts, top-2, d 64, f 64) with the given
    router, capacity factor and shared experts, as tests/test_moe_sparse.py
    builds it; ``kw`` overrides more fields."""
    jc = dataclasses.replace(get_config("mixtral-8x22b").reduced(), moe_router=router,
                             moe_capacity_factor=cap_factor, n_shared_experts=shared,
                             **kw)
    return jc, tconfigs.ArchConfig(**dataclasses.asdict(jc))


def params(jc, dtype=jnp.float32, seed=0):
    """JAX MoE params, with a random router bias for the deepseek router
    (zeros at init would leave the bias untested); and the port's copy."""
    p = JM.moe_init(jax.random.PRNGKey(seed), jc, dtype)
    if jc.moe_router == "deepseek":
        bias = np.random.default_rng(seed).standard_normal(jc.n_experts) * 0.1
        p["router_bias"] = jnp.asarray(bias, jnp.float32)
    return p, map_params(to_tensor, jax.tree.map(np.asarray, p))


def inputs(shape, dtype=np.float32, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, to_tensor(np.asarray(jx))


def route(pkg, router, p, x, k):
    fn = pkg._route_deepseek if router == "deepseek" else pkg._route_mixtral
    return fn(p, x, k)


def assert_bf16_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ULPS * np.abs(want).max())


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("n_experts,k", [(4, 2), (16, 8), (64, 6)])
def test_routing_matches_reference(router, dtype, n_experts, k):
    jc, _ = cfgs(router, n_experts=n_experts, moe_top_k=k)
    jp, tp = params(jc, jnp.dtype(dtype), seed=2)
    jx, tx = inputs((48, jc.d_model), jnp.dtype(dtype), seed=3)
    want = route(JM, router, jp, jx, k)
    got = route(TM, router, tp, tx, k)
    assert got.expert.dtype == torch.int32 and got.weight.dtype == torch.float32
    np.testing.assert_array_equal(got.expert.numpy(), np.asarray(want.expert))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=0, atol=1e-6)


def test_top_k_breaks_ties_toward_the_lower_index():
    """Scores with many ties: the same ids and order as ``jax.lax.top_k``."""
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 4, (64, 16)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
    got_v, got_i = TM._top_k(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------------------ dispatch


def _assignments(T, k, E, seed, skew):
    """(eid, gate) for T tokens, k distinct experts each; ``skew`` > 0 draws
    experts from a Zipf-like law so that some overflow their capacity."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, E + 1) ** skew
    eid = np.stack([rng.choice(E, k, replace=False, p=w / w.sum()) for _ in range(T)])
    gate = rng.random((T, k)).astype(np.float32)
    return eid.astype(np.int32).reshape(-1), gate.reshape(-1)


DISPATCH_CASES = [(32, 2, 4, 8.0, 0.0), (32, 2, 4, 0.25, 0.0), (64, 2, 8, 1.25, 1.5),
                  (40, 8, 16, 1.25, 1.0), (8, 8, 64, 1.25, 0.0), (4, 2, 8, 1.25, 0.0)]


@pytest.mark.parametrize("T,k,E,cap_factor,skew", DISPATCH_CASES)
def test_dispatch_arrays_equal_reference(T, k, E, cap_factor, skew):
    """xbuf, asg_slot, tok_s, gate_s and keep, array for array, at ample
    capacity, the tight factor 0.25 of tests/test_moe_sparse.py and skewed
    loads that drop assignments; dtypes too (int32 slots and tokens)."""
    jc, tc = cfgs(cap_factor=cap_factor, n_experts=E, moe_top_k=k)
    cap = jc.moe_capacity(T)
    assert cap == tc.moe_capacity(T)
    eid, gate = _assignments(T, k, E, seed=T + E, skew=skew)
    x = np.random.default_rng(5).standard_normal((T, jc.d_model)).astype(np.float32)
    jbuf, jmeta = JM._local_dispatch(jnp.asarray(x), jnp.asarray(eid),
                                     jnp.asarray(gate), E, cap)
    tbuf, tmeta = TM._local_dispatch(torch.from_numpy(x), torch.from_numpy(eid),
                                     torch.from_numpy(gate), E, cap)
    assert tuple(tbuf.shape) == jbuf.shape == (E, cap, jc.d_model)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for name, got, want in zip(("asg_slot", "tok_s", "gate_s", "keep"), tmeta, jmeta):
        want = np.asarray(want)
        assert np_of(got).dtype == want.dtype, name
        np.testing.assert_array_equal(np_of(got), want, err_msg=name)
    dropped = int((~tmeta[3]).sum())
    if cap_factor < 1 or skew > 1:
        assert dropped > 0  # the case does exercise the overflow path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,k,E,cap_factor,skew", DISPATCH_CASES)
def test_combine_equals_reference(T, k, E, cap_factor, skew, dtype):
    """The combine on the same slot buffers and metadata: equal to the
    reference's scatter-add in f32 and in bf16, where with k = 8 the order
    of the sums shows."""
    jc, _ = cfgs(cap_factor=cap_factor, n_experts=E, moe_top_k=k)
    cap = jc.moe_capacity(T)
    eid, gate = _assignments(T, k, E, seed=T + E, skew=skew)
    x = np.zeros((T, 8), np.float32)
    _, jmeta = JM._local_dispatch(jnp.asarray(x), jnp.asarray(eid), jnp.asarray(gate),
                                  E, cap)
    _, tmeta = TM._local_dispatch(torch.from_numpy(x), torch.from_numpy(eid),
                                  torch.from_numpy(gate), E, cap)
    ybuf = np.random.default_rng(6).standard_normal((E, cap, 24)).astype(np.float32)
    jy = JM._local_combine(jnp.asarray(ybuf, dtype), jmeta, T, 24)
    ty = TM._local_combine(to_tensor(np.asarray(jnp.asarray(ybuf, dtype))), tmeta, T)
    assert np_of(ty).dtype == np_of(jy).dtype
    np.testing.assert_array_equal(np_of(ty), np_of(jy))


# ------------------------------------------------------------------ moe_apply


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("cap_factor", [8.0, 1.25, 0.25])
def test_moe_apply_matches_reference_f32(router, shared, cap_factor):
    jc, tc = cfgs(router, cap_factor, shared)
    jp, tp = params(jc, seed=7)
    jx, tx = inputs((2, 16, jc.d_model), seed=8)
    want = JM.moe_apply(jp, jx, jc)
    got = TM.moe_apply(tp, tx, tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("router,n_experts,k", [("mixtral", 4, 2), ("deepseek", 4, 2),
                                                ("deepseek", 16, 8)])
def test_moe_apply_matches_reference_bf16(router, n_experts, k, shared):
    """bf16 params and x: routing equal, the output within 4 bf16 ulps of
    its scale (the expert products and SiLU round to bf16 at other places
    in the two frameworks)."""
    jc, tc = cfgs(router, 1.25, shared, n_experts=n_experts, moe_top_k=k)
    jp, tp = params(jc, jnp.bfloat16, seed=9)
    jx, tx = inputs((2, 20, jc.d_model), jnp.bfloat16, seed=10)
    jr = route(JM, router, jp, jx.reshape(-1, jc.d_model), k)
    tr = route(TM, router, tp, tx.reshape(-1, tc.d_model), k)
    np.testing.assert_array_equal(tr.expert.numpy(), np.asarray(jr.expert))
    got = TM.moe_apply(tp, tx, tc)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, JM.moe_apply(jp, jx, jc))


@pytest.mark.parametrize("router", ROUTERS)
def test_moe_matches_per_token_oracle(router):
    """Ample capacity: the port equals a per-token loop over its top-k
    experts (tests/test_moe_sparse.py's oracle, on the port's routing),
    within that test's rtol = atol = 2e-3."""
    jc, tc = cfgs(router)
    _, tp = params(jc, seed=11)
    _, tx = inputs((2, 16, tc.d_model), seed=12)
    got = TM.moe_apply(tp, tx, tc).reshape(-1, tc.d_model).numpy()
    xf = tx.reshape(-1, tc.d_model)
    r = route(TM, router, tp, xf, tc.moe_top_k)
    wg, wu, wd = (tp[n].numpy() for n in ("w_gate", "w_up", "w_down"))
    want = np.zeros_like(got)
    for t_ in range(xf.shape[0]):
        for j in range(tc.moe_top_k):
            e = int(r.expert[t_, j])
            h, u = xf[t_].numpy() @ wg[e], xf[t_].numpy() @ wu[e]
            want[t_] += float(r.weight[t_, j]) * ((h / (1 + np.exp(-h)) * u) @ wd[e])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_capacity_drops_tokens_gracefully():
    """The tight factor 0.25 drops assignments: the port's output is finite,
    differs from the ample run, stays below it in mass (as
    tests/test_moe_sparse.py asks of the reference), and equals the
    reference's tight output within 2e-4."""
    (jt, tt), (ja, ta) = cfgs(cap_factor=0.25), cfgs(cap_factor=8.0)
    jp, tp = params(jt, seed=13)
    jx, tx = inputs((2, 32, jt.d_model), seed=14)
    y_tight, y_ample = TM.moe_apply(tp, tx, tt), TM.moe_apply(tp, tx, ta)
    assert torch.isfinite(y_tight).all()
    assert not torch.allclose(y_tight, y_ample)
    assert y_tight.abs().sum() < y_ample.abs().sum() * 1.01
    np.testing.assert_allclose(y_tight.numpy(), np.asarray(JM.moe_apply(jp, jx, jt)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("router", ROUTERS)
def test_moe_grads_match_jax_grad(router, shared):
    """jax.grad of sum(moe_apply(p, x)^2) against autograd, for every param
    and x: within 1e-6 of each leaf's largest |g| (f32).  The router bias
    only selects (top-k): zero gradient in JAX, none reaches it here."""
    jc, tc = cfgs(router, 1.25, shared)
    jp, tp = params(jc, seed=15)
    jx, tx = inputs((1, 16, jc.d_model), seed=16)
    jg, jgx = jax.grad(lambda p, x: jnp.sum(JM.moe_apply(p, x, jc) ** 2),
                       argnums=(0, 1))(jp, jx)
    leaves = {k: v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    flat = [v.clone().requires_grad_() for v in leaves.values()]
    tpg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), flat)
    txg = tx.clone().requires_grad_()
    (TM.moe_apply(tpg, txg, tc) ** 2).sum().backward()
    for (path, _), leaf, want in zip(leaves.items(), flat, jax.tree.leaves(jg)):
        want = np.asarray(want)
        name = jax.tree_util.keystr(path)
        if "router_bias" in name:
            assert leaf.grad is None and not want.any()
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)
    want = np.asarray(jgx)
    np.testing.assert_allclose(txg.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_moe_apply_is_bit_reproducible():
    """Two calls on the same inputs give the same bits (no atomics)."""
    jc, tc = cfgs("deepseek", 1.25, 1, n_experts=16, moe_top_k=8)
    _, tp = params(jc, jnp.bfloat16, seed=17)
    _, tx = inputs((2, 24, tc.d_model), jnp.bfloat16, seed=18)
    assert torch.equal(TM.moe_apply(tp, tx, tc), TM.moe_apply(tp, tx, tc))


def test_moe_init_tree_and_shapes_match_reference():
    for router, shared in (("mixtral", 0), ("deepseek", 1)):
        jc, tc = cfgs(router, shared=shared)
        jp = JM.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
        tp = TM.moe_init(torch.Generator().manual_seed(0), tc, torch.float32)
        jl = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        tl = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert set(tl) == set(jl)
        for name, v in tl.items():
            assert tuple(v.shape) == jl[name].shape, name
            assert np_of(v).dtype == np.asarray(jl[name]).dtype, name
        assert abs(float(tp["w_down"].std()) - tc.moe_d_ff ** -0.5) < 0.01
        assert float(tp["router"]["w"].std()) < 0.03
