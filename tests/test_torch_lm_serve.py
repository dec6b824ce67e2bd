"""The port's LM serving path (``repro_torch.models.lm`` prefill / decode and
``repro_torch.launch.serve.Server``) against the JAX package.

The reference's params (float32, reduced configs) are carried across by
``repro_torch.convert.lm_params``; prompts and modality embeddings come
from numpy seeds.  Logits agree within rtol = atol = 2e-4; greedy tokens
must be equal.  Each arch runs dense and with the block-sparse FFN
(``ffn_density=0.5``, (8, 16) blocks, as tests/test_moe_sparse.py uses at
the reduced width), except mixtral-8x22b, whose every FFN is an MoE (its
experts stay dense in both packages).  The MoE archs run at their default
capacity factor, so both packages drop the same assignments; the
consistency test alone widens it (tests/test_archs.py does the same).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as TLM
from repro_torch.sparse.layers import DERIVED

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen1.5-0.5b", "llama3.2-1b", "smollm-360m", "gemma2-27b",
         "llava-next-34b", "mixtral-8x22b", "deepseek-v3-671b"]
MODELS = [(a, s) for a in ARCHS for s in (False, True)
          if not (s and a == "mixtral-8x22b")]
B, S, MAX_LEN = 2, 16, 32


def configs(arch, sparse):
    cfg = get_config(arch).reduced()
    if sparse:
        cfg = dataclasses.replace(cfg, ffn_density=0.5, sparse_block=(8, 16))
    return cfg, tconfigs.ArchConfig(**dataclasses.asdict(cfg))


def f32_params(params):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, params)


@pytest.fixture(scope="module", params=MODELS,
                ids=lambda p: f"{p[0]}-{'sparse' if p[1] else 'dense'}")
def model(request):
    """(JAX cfg, port cfg, JAX params, port params, inputs) for one arch."""
    arch, sparse = request.param
    jc, tc = configs(arch, sparse)
    params = JLM.init_params(jax.random.PRNGKey(1), jc, jnp.float32)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), tc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    pe = (rng.standard_normal((B, jc.modality_tokens, jc.d_model)).astype(np.float32)
          if jc.modality_tokens else None)
    return jc, tc, params, tparams, toks, pe


def _pe(pe, port):
    if pe is None:
        return None
    return torch.from_numpy(pe) if port else jnp.asarray(pe)


def test_param_tree_keys_and_sparse_row_pointers(model):
    jc, tc, params, tparams, _, _ = model
    jkeys = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)}
    tkeys = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(tparams)}
    extra = tkeys - jkeys
    assert jkeys <= tkeys
    if jc.ffn_density < 1:
        assert extra and {k[k.rindex("['") + 2:-2] for k in extra} == set(DERIVED)
        if "mlp" in tparams["blocks"]["b0"]:
            ptr = tparams["blocks"]["b0"]["mlp"]["w_down"]["browptr"]
            assert ptr.shape == (jc.n_repeats, jc.d_model // 8 + 1)
        else:  # deepseek: the dense prefix layers and the MTP block
            for blk in [tparams[f"prefix{i}"] for i in range(len(jc.prefix_pattern))] \
                    + [tparams["mtp"]["block"]]:
                assert blk["mlp"]["w_down"]["browptr"].shape == (jc.d_model // 8 + 1,)
    else:
        assert not extra


def test_prefill_and_decode_logits_match_reference(model):
    jc, tc, params, tparams, toks, pe = model
    prompt, nxt = toks[:, :S], toks[:, S:]
    jl, jcache = JLM.prefill(params, jnp.asarray(prompt), jc, MAX_LEN,
                             prefix_embeds=_pe(pe, False))
    tl, tcache = TLM.prefill(tparams, torch.from_numpy(prompt), tc, MAX_LEN,
                             prefix_embeds=_pe(pe, True))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pairs = list(zip(tcache.prefix, jcache.prefix)) + [
        (c, jcache.blocks[key]) for key, c in tcache.blocks.items()]
    for c, jc_ in pairs:  # KVCache (k, v) or MLACache (ckv, krope)
        for a, b in zip(c[:-1], jc_[:-1]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert c.length == S + jc.modality_tokens
    for step in range(2):
        jl, jcache = JLM.decode_step(params, jnp.asarray(nxt), jcache, jc)
        tl, tcache = TLM.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_forward_matches_reference(model):
    jc, tc, params, tparams, toks, pe = model
    jlog, jh = JLM.forward(params, jnp.asarray(toks), jc,
                           prefix_embeds=_pe(pe, False), remat=False)
    tlog, th = TLM.forward(tparams, torch.from_numpy(toks), tc,
                           prefix_embeds=_pe(pe, True))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_prefill_decode_consistency(model):
    """decode(prefill(S)) last logits == prefill(S+1) last logits, at the
    tolerance of tests/test_archs.py:test_prefill_decode_consistency."""
    _, tc, _, tparams, toks, pe = model
    if tc.n_experts:  # exactness needs ample capacity (no token drops)
        tc = dataclasses.replace(tc, moe_capacity_factor=8.0)
    tokens = torch.from_numpy(toks)
    _, caches = TLM.prefill(tparams, tokens[:, :S], tc, MAX_LEN,
                            prefix_embeds=_pe(pe, True))
    got, _ = TLM.decode_step(tparams, tokens[:, S:], caches, tc)
    want, _ = TLM.prefill(tparams, tokens, tc, MAX_LEN, prefix_embeds=_pe(pe, True))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch,sparse", [("qwen1.5-0.5b", False),
                                         ("qwen1.5-0.5b", True),
                                         ("gemma2-27b", False),
                                         ("mixtral-8x22b", False),
                                         ("deepseek-v3-671b", False),
                                         ("deepseek-v3-671b", True)])
def test_server_generate_equals_reference_server(arch, sparse):
    jc, tc = configs(arch, sparse)
    max_len = 24
    jsrv = jserve.Server(jc, make_local_mesh(), max_len)
    jsrv.params = f32_params(jsrv.params)
    tsrv = tserve.Server(tc, max_len, device="cpu", dtype=torch.float32)
    tsrv.params = convert.lm_params(jax.tree.map(np.asarray, jsrv.params), tc)
    prompts = np.random.default_rng(2).integers(0, jc.vocab, (3, 12)).astype(np.int32)
    want = jsrv.generate(prompts, 10)
    got = tsrv.generate(prompts, 10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_tokens", [0, 1, 2])
def test_server_generate_short_runs_equal_reference_server(n_tokens):
    """The prefill's token always, then n_tokens - 1 decode steps: (B,
    max(n_tokens, 1)) tokens, equal to the JAX ``Server``'s."""
    jc, tc = configs("qwen1.5-0.5b", False)
    jsrv = jserve.Server(jc, make_local_mesh(), 16)
    jsrv.params = f32_params(jsrv.params)
    tsrv = tserve.Server(tc, 16, device="cpu", dtype=torch.float32)
    tsrv.params = convert.lm_params(jax.tree.map(np.asarray, jsrv.params), tc)
    prompts = np.random.default_rng(4).integers(0, jc.vocab, (2, 8)).astype(np.int32)
    want = jsrv.generate(prompts, n_tokens)
    got = tsrv.generate(prompts, n_tokens)
    assert want.shape == (2, max(n_tokens, 1))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_server_own_init_is_seeded_and_in_range():
    _, tc = configs("qwen1.5-0.5b", True)
    prompts = np.random.default_rng(3).integers(0, tc.vocab, (2, 8)).astype(np.int32)
    outs = [tserve.Server(tc, 16, device="cpu").generate(prompts, 6)
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 6)
    assert ((0 <= outs[0]) & (outs[0] < tc.vocab)).all()
    srv = tserve.Server(tc, 16, device="cpu")
    assert srv.params["embed"]["emb"].dtype == torch.bfloat16


def test_server_defaults_to_the_card(monkeypatch):
    _, tc = configs("qwen1.5-0.5b", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tserve.Server(tc, 16)


def test_server_rejects_unported_archs():
    """The encoder-decoder needs frames, which Server does not take: it
    names the step builders that serve it."""
    _, tc = configs("seamless-m4t-medium", False)
    with pytest.raises(ValueError, match="make_prefill_step.*make_decode_step"):
        tserve.Server(tc, 16, device="cpu")


def test_main_on_the_cpu(capsys):
    out = tserve.main(["--arch", "llama3.2-1b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4)
    assert "generated (2, 4)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_main_serves_the_moe_archs_on_the_cpu(capsys, arch):
    """``--arch`` takes both MoE archs with no new flag."""
    out = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert "generated (2, 4)" in capsys.readouterr().out
