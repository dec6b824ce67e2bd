"""Training the recurrent kinds and the encoder-decoder on a process mesh:
the port's gloo ranks against the JAX package's 4-device mesh.

One 4-rank gloo world on the CPU per module (bodies in
tests/_torch_lm_world_train_recurrent_runner.py) and, beside it, the JAX
package on 4 fake CPU devices in two subprocesses
(tests/_torch_lm_mesh_train_recurrent_runner.py), on the cases of
tests/_torch_lm_mesh_train_recurrent_cases.py: the reduced zamba2 on
(1, 4) sparse and on (2, 2) dense, at 12 layers on (2, 2) sparse (the
shared block invoked twice, each invocation rematerialized) and with 2
microbatches; the reduced xlstm (7 mLSTM blocks and sLSTM's per-token
loop) on (1, 4) and (2, 2); the reduced seamless with f32 frames on
(2, 2) sparse and on (1, 4) at vocab 258.  Both packages hold the same f32
weights and batch.

For each case: the loss within 1e-5 relative of JAX's
``_value_and_grad_trainable(lm.loss_fn)`` under ``set_mesh``; each rank's
block of every gradient leaf within 1e-4 of the JAX leaf's max |g|; after
one ``make_train_step`` step each rank's param blocks within 1e-5 of the
leaf's max |p| wherever |g| > 1e-3 · max |g| (as
tests/test_torch_lm_mesh_train.py says why); once with int8 second
moments; each rank's collective calls and bytes by kind equal to
``analysis.sharded.train_collectives`` and its calls of the block kernel's
wrapper to ``train_block_kernel_launches``.  ``TrainLoop(mesh=)`` on
zamba2 (2, 2) recovers from an injected failure to the uninterrupted
run's losses, which are JAX's ``TrainLoop``'s within 1e-5; a checkpoint
written on (2, 2) restores onto the 2-rank (1, 2) mesh and onto (1, 4)
and trains on within 1e-5 of the (2, 2) run, and so does xlstm's;
checkpoints cross between the packages both ways.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.world import spawn

from _torch_lm_mesh_cases import _paths, config
from _torch_lm_mesh_train_recurrent_cases import (B, CASES, ELASTIC_AT, ELASTIC_MP,
                                                  ELASTIC_STEPS, FAIL_AT, LOOP_ARCH,
                                                  LOOP_STEPS, OPT, QUANT_CASE, S,
                                                  XLSTM_AT, XLSTM_STEPS)
from _torch_lm_mesh_train_recurrent_cases import frames as enc_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_IDS = [c[0] for c in CASES]
S_ENC = enc_frames(get_config("seamless-m4t-medium").reduced()).shape[1]

# the JAX side in two processes of about equal length
JAX_PARTS = (",".join(c for c in CASE_IDS if c.startswith("zamba2")),
             ",".join([c for c in CASE_IDS if not c.startswith("zamba2")] + ["loop"]))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, every rank's results, the 2-rank world's, the
    checkpoint directory): the JAX runners run in subprocesses while the
    ranks run."""
    import _torch_lm_world_train_recurrent_runner as wr

    out_dir = tmp_path_factory.mktemp("lm_mesh_train_recurrent")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_lm_mesh_train_recurrent_runner.py"),
         str(out_dir / f"jax{i}.npz"), str(out_dir), part], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for i, part in enumerate(JAX_PARTS)]
    try:
        ranks = spawn(wr.train_cases, 4, "gloo", device="cpu", args=(str(out_dir),),
                      timeout=300)
        small = spawn(wr.elastic_world, 2, "gloo", device="cpu",
                      args=(str(out_dir),), timeout=300)
        outs = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    jax_res = {}
    for i, (proc, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            pytest.fail(f"LM mesh train runner crashed:\n{stderr[-3000:]}")
        if "LM MESH SKIP" in stdout:
            pytest.skip("forcing 4 fake JAX devices failed")
        with np.load(out_dir / f"jax{i}.npz") as z:
            jax_res.update(z)
    return jax_res, ranks, small, out_dir


def _case(case_id):
    return next(c for c in CASES if c[0] == case_id)


_SHARDINGS: dict = {}


def _shardings(case_id, coords) -> dict:
    """{path: the sanitized NamedSharding} of the case's params at the rank
    at ``coords``: the blocks that rank holds."""
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.launch.steps import mesh_param_shardings

    key = (case_id, tuple(coords))
    if key not in _SHARDINGS:
        _, arch, shape, overrides, _ = _case(case_id)
        mesh = dry_process_mesh(shape, ("data", "model"),
                                rank=int(np.ravel_multi_index(coords, shape)))
        _SHARDINGS[key] = dict(_paths(mesh_param_shardings(
            config(get_config, arch, overrides), mesh)))
    return _SHARDINGS[key]


def _block(want: np.ndarray, sh) -> np.ndarray:
    """The block of the full leaf ``want`` that ``sh``'s rank holds."""
    return sh.local(torch.from_numpy(want)).numpy()


def _match(want, got, sh, mask=None) -> float:
    """max |error| of ``got`` against its rank's block of ``want`` (where
    ``mask``'s block is true)."""
    blk = _block(want, sh)
    assert blk.shape == got.shape, (blk.shape, got.shape)
    err = np.abs(blk - got)
    if mask is not None:
        err = np.where(_block(mask, sh), err, 0)
    return err.max()


_ONE_DEVICE: dict = {}


def _one_device_grads(case_id) -> dict:
    """{path: gradient} of the case's loss from the port on one device
    (the control of a leaf the model's rounding moves past 1e-4)."""
    if case_id not in _ONE_DEVICE:
        from repro_torch import convert
        from repro_torch.launch.steps import loss_and_grads

        from _torch_lm_mesh_train_recurrent_cases import batch
        from _torch_lm_world_train_runner import full_params, numpy_tree

        _, arch, _, overrides, _ = _case(case_id)
        cfg = config(get_config, arch, overrides)
        b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
        _, g = loss_and_grads(convert.lm_params(full_params(cfg), cfg), b, cfg)
        _ONE_DEVICE[case_id] = numpy_tree(g)
    return _ONE_DEVICE[case_id]


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_loss_and_grads_match_the_jax_mesh(sides, case_id):
    """Each rank's gradient blocks within 1e-4 of the JAX leaf's max |g|.
    These models' f32 gradients move that far under rounding alone: the
    reduced xlstm's first mLSTM ``wk`` moves 0.75e-4-1.21e-4 of its max
    when the port's params are perturbed by 1e-7 relative (0.57e-4 for the
    reference's), and the port on one device sits 1.09e-4 from the JAX
    (1, 4) mesh there.  So where the one-device port is itself farther
    than 1e-4 from the JAX mesh, a rank may be as far as it plus 1e-5 of
    the max: what the mesh adds stays under 1e-5."""
    jax_res, ranks, _, _ = sides
    want_loss = float(jax_res[f"{case_id}|loss"])
    for rank in ranks:
        got = rank[case_id]
        shs = _shardings(case_id, got["coords"])
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        for path, g in got["grads"].items():
            if g.dtype.kind != "f":
                continue
            want = jax_res[f"{case_id}|grads|{path}"]
            top = max(np.abs(want).max(), 1e-30)
            err = _match(want, g, shs[path])
            if err > 1e-4 * top:
                control = np.abs(_one_device_grads(case_id)[path] - want).max()
                tol = max(1e-4 * top, control + 1e-5 * top)
                assert err <= tol, (case_id, path, got["coords"], err, control, tol)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_one_train_step_matches_the_jax_mesh(sides, case_id):
    jax_res, ranks, _, _ = sides
    for rank in ranks:
        got = rank[case_id]
        shs = _shardings(case_id, got["coords"])
        np.testing.assert_allclose(got["step_loss"],
                                   float(jax_res[f"{case_id}|step_loss"]), rtol=1e-5)
        for path, p in got["params"].items():
            want = jax_res[f"{case_id}|params|{path}"]
            if p.dtype.kind != "f":
                assert _match(want, p, shs[path]) == 0, path
                continue
            g = np.abs(jax_res[f"{case_id}|grads|{path}"])
            tol = 1e-5 * np.abs(want).max()
            err = _match(want, p, shs[path], mask=g > 1e-3 * g.max())
            assert err <= tol, (case_id, path, got["coords"], err, tol)


def test_int8_moments_match_the_jax_mesh(sides):
    """zamba2 on (2, 2) with int8 second moments: the clip's psum and the
    scales' all-gather cover the recurrent leaves (the f32 decay rates and
    skips among them).  A leaf's scale is (1 - b2) max g^2 / 127 over the
    whole leaf: within 1e-5 relative of JAX's, plus twice the relative gap
    between the two packages' max |g| of the leaf (every rank's blocks),
    which the square carries (the Mamba2 norm's largest gradient differs
    by 5.6e-6 relative, a rounding the grads test allows)."""
    jax_res, ranks, _, _ = sides
    top = {}
    for rank in ranks:
        for path, g in rank[QUANT_CASE]["grads"].items():
            top[path] = max(top.get(path, 0.0), float(np.abs(g).max()) if g.size else 0.0)
    for rank in ranks:
        got = rank[QUANT_CASE]
        shs = _shardings(QUANT_CASE, got["coords"])
        for path, a in got["quant_v"].items():
            want = jax_res[f"{QUANT_CASE}|quant_v|{path}"]
            if path.endswith("/scale"):
                leaf = path.rpartition("/")[0]
                jmax = np.abs(jax_res[f"{QUANT_CASE}|grads|{leaf}"]).max()
                gap = abs(top[leaf] / jmax - 1) if jmax else 0.0
                np.testing.assert_allclose(a, want, rtol=1e-5 + 2 * gap, err_msg=path)
                continue
            blk = _block(want, shs[path.rpartition("/")[0]])
            assert blk.shape == a.shape, path
            diff = np.abs(blk.astype(int) - a.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99, path
        for path, p in got["quant_params"].items():
            want = jax_res[f"{QUANT_CASE}|quant_params|{path}"]
            if p.dtype.kind == "f":
                g = np.abs(jax_res[f"{QUANT_CASE}|grads|{path}"])
                tol = 1e-5 * np.abs(want).max()
                assert _match(want, p, shs[path], mask=g > 1e-3 * g.max()) <= tol, path


@pytest.mark.parametrize("case_id", CASE_IDS + [QUANT_CASE + "|int8"])
def test_train_collectives_match_their_closed_form(sides, case_id):
    """Every rank's collective calls and bytes, by kind, over one train
    step: the encoder's pass and the decoder's cross-attention over its
    S_ENC rows, the recurrent blocks' transposes (the heads' slices of the
    replicated leaves all-gathered), the recompute of every repeat, the
    gradient sums and the clip's (and the int8 scales' all-gather)."""
    from repro_torch.analysis.sharded import train_collectives

    _, ranks, _, _ = sides
    base, _, quant = case_id.partition("|")
    _, arch, shape, overrides, mb = _case(base)
    cfg = config(get_config, arch, overrides)
    want = train_collectives(cfg, shape, B, S, cfg.remat, microbatches=mb,
                             quantized=bool(quant), itemsize=4,
                             S_mem=S_ENC if cfg.encoder_layers else 0)
    for rank in ranks:
        got = rank[base]["quant_coll" if quant else "coll"]
        assert got["calls"] == want["calls"], (case_id, got["calls"], want["calls"])
        assert got["bytes"] == want["bytes"], (case_id, got["bytes"], want["bytes"])


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_block_kernel_calls_match_their_closed_form(sides, case_id):
    """Every rank's calls of the block kernel's wrapper in one step (each
    a launch on the card): the sparse FFN's forward, recompute and grad x
    in zamba2's shared block and seamless's decoder layers, the forward and
    grad x in seamless's encoder layers, none in a recurrent block."""
    from repro_torch.analysis.sharded import train_block_kernel_launches

    _, ranks, _, _ = sides
    _, arch, _, overrides, mb = _case(case_id)
    cfg = config(get_config, arch, overrides)
    want = train_block_kernel_launches(cfg, microbatches=mb, remat=cfg.remat)
    assert (want > 0) == (cfg.ffn_density < 1)
    for rank in ranks:
        assert rank[case_id]["kernel_calls"] == want, (case_id, rank["coords"])


def test_train_loop_on_a_mesh_recovers_and_matches_the_jax_loop(sides):
    """A failure at step FAIL_AT restores the last checkpoint and replays
    to the uninterrupted run's losses, on every rank; those are JAX's
    TrainLoop's on its (2, 2) mesh within 1e-5."""
    jax_res, ranks, _, _ = sides
    want = jax_res["loop|losses"]
    for rank in ranks:
        plain, fault = rank["loops"]["plain"], rank["loops"]["fault"]
        assert len(plain) == LOOP_STEPS and np.all(np.isfinite(plain))
        assert len(fault) > LOOP_STEPS
        np.testing.assert_allclose(fault[-(LOOP_STEPS - FAIL_AT + 1):],
                                   plain[FAIL_AT - 1:], rtol=0, atol=0)
        np.testing.assert_allclose(plain, want, rtol=1e-5)


def test_elastic_restore_onto_a_smaller_mesh(sides):
    """4 ranks on (2, 2) write step ELASTIC_AT; a 2-rank world on
    rescale_mesh_shape(2, model_parallel=2) restores it, keeps the global
    batch and trains to ELASTIC_STEPS within 1e-5 of the 4-rank run."""
    from repro_torch.runtime.elastic import rescale_mesh_shape

    _, ranks, small, _ = sides
    want = ranks[0]["loops"]["elastic_tail"]
    for rank in small:
        assert rank["shape"] == rescale_mesh_shape(2, ("data", "model"), ELASTIC_MP)
        assert rank["restored"] and rank["step"] == ELASTIC_AT
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5)
        assert len(rank["losses"]) == ELASTIC_STEPS - ELASTIC_AT


def test_elastic_restore_onto_the_model_parallel_mesh(sides):
    """The same checkpoint restored by the 4 ranks onto (1, 4): every
    "model" rank holds one of zamba2's 4 SSM heads; the losses are the
    (2, 2) run's within 1e-5."""
    _, ranks, _, _ = sides
    want = ranks[0]["loops"]["elastic_tail"]
    for rank in ranks:
        wide = rank["loops"]["elastic_1x4"]
        assert wide["restored"] and wide["step"] == ELASTIC_AT
        np.testing.assert_allclose(wide["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("where", ["1x4", "1x2"])
def test_xlstm_checkpoint_restores_onto_other_meshes(sides, where):
    """xlstm's tree (mLSTM and sLSTM blocks, sLSTM's f32 recurrent weights
    split by heads) written on (2, 2) at step XLSTM_AT restores onto (1, 4)
    (the 4 ranks) and onto the 2-rank (1, 2) mesh, and trains on within
    1e-5 of the (2, 2) run."""
    _, ranks, small, _ = sides
    want = ranks[0]["loops"]["xlstm_tail"]
    got = ([r["loops"]["xlstm_1x4"] for r in ranks] if where == "1x4"
           else [r["xlstm"] for r in small])
    for row in got:
        assert row["shape"] == (1, int(where[-1]))
        assert row["restored"] and row["step"] == XLSTM_AT
        assert len(row["losses"]) == XLSTM_STEPS - XLSTM_AT
        np.testing.assert_allclose(row["losses"], want, rtol=1e-5)


def _jax_like():
    """The JAX reference's (params, opt) template of the loop's config."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import lm as JLM
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import init_opt as jinit_opt

    cfg = config(jget, LOOP_ARCH, {})
    params = JLM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return params, jinit_opt(params, JAdamW(**OPT))


def test_port_mesh_checkpoint_restores_in_jax(sides):
    """The zamba2 checkpoint the 4 ranks wrote (the full leaves: the
    Mamba2 stack, the shared block, the f32 decay rates) is the gathered
    state, bit for bit, read by JAX's restore_checkpoint."""
    import jax

    from repro.runtime import checkpoint as JCK

    _, ranks, _, out_dir = sides
    (params, opt), step = JCK.restore_checkpoint(str(out_dir / "elastic"), _jax_like())
    assert step == ELASTIC_AT
    state = ranks[0]["loops"]["elastic_state"]
    got_p = dict(_paths(jax.tree.map(np.asarray, params)))
    got_m = dict(_paths(jax.tree.map(np.asarray, opt.m)))
    assert set(got_p) == set(state["params"])
    for path, a in state["params"].items():
        np.testing.assert_array_equal(got_p[path], a, err_msg=path)
    for path, a in state["m"].items():
        np.testing.assert_array_equal(got_m[path], a, err_msg=path)


@pytest.mark.parametrize("rank", range(4))
def test_jax_mesh_checkpoint_restores_onto_the_port_mesh(sides, rank):
    """JAX's TrainLoop on its zamba2 (2, 2) mesh wrote full leaves; the
    port restores them onto each rank of a (2, 2) mesh as that rank's
    blocks."""
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.launch import steps as TS
    from repro_torch.models import lm as TLM
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.runtime import restore_checkpoint
    from repro_torch.runtime.elastic import make_shardings, sanitize_shardings
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves, tree_map

    _, _, _, out_dir = sides
    cfg = config(get_config, LOOP_ARCH, {})
    params = strip_derived(TLM.init_params(torch.Generator().manual_seed(0), cfg,
                                           torch.float32))
    ckpt = str(out_dir / "jax_ckpt")
    full, step = restore_checkpoint(ckpt, (params, init_opt(params, AdamWConfig(**OPT))))
    mesh = dry_process_mesh((2, 2), ("data", "model"), rank=rank)
    pspecs, ospecs = TS.state_specs(cfg, AdamWConfig(**OPT))
    sh = (sanitize_shardings(make_shardings(mesh, pspecs), full[0]),
          sanitize_shardings(make_shardings(mesh, ospecs), full[1]))
    blocks = tree_map(lambda t, s: s.local(t).clone(), full, sh,
                      is_leaf=lambda x: hasattr(x, "spec"))
    got, got_step = restore_checkpoint(ckpt, blocks, shardings=sh)
    assert got_step == step == LOOP_STEPS
    for a, b in zip(leaves(got), leaves(blocks)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert any(a.shape != f.shape for a, f in zip(leaves(got), leaves(full)))


# (arch, config changes, microbatches, launches a step): full width at
# ffn_density 0.5.  zamba2's shared block is its only FFN: one invocation
# a repeat, 3 projections x (forward, recompute, grad x) = 9 at 6 layers
# (phase 19's reading on the card), 18 at 12; xlstm has none; seamless's
# decoder layers 9 each and its encoder layers 6 each (forward and grad
# x: the encoder is not rematerialized); qwen's 24 layers 216 (phase 15's
# reading), deepseek's 3 prefix layers and MTP block 24 a microbatch,
# mixtral's MoE layers none.
LAUNCH_CASES = (
    ("zamba2-2.7b", dict(n_layers=6), 1, 9),
    ("zamba2-2.7b", dict(n_layers=12), 1, 18),
    ("xlstm-1.3b", dict(n_layers=8), 1, 0),
    ("seamless-m4t-medium", dict(n_layers=2, encoder_layers=2), 1, 30),
    ("seamless-m4t-medium", dict(n_layers=4, encoder_layers=4), 1, 60),
    ("seamless-m4t-medium", dict(n_layers=2, encoder_layers=4), 1, 42),
    ("qwen1.5-0.5b", {}, 1, 216),
    ("deepseek-v3-671b", {}, 2, 48),
    ("mixtral-8x22b", {}, 1, 0),
)


@pytest.mark.parametrize("arch,changes,mb,want", LAUNCH_CASES,
                         ids=[f"{a}-{c.get('n_layers', 'full')}-{c.get('encoder_layers', '')}"
                              for a, c, _, _ in LAUNCH_CASES])
def test_train_block_kernel_launches_at_full_width(arch, changes, mb, want):
    import dataclasses

    from repro_torch.analysis.sharded import train_block_kernel_launches

    cfg = dataclasses.replace(get_config(arch), ffn_density=0.5, **changes)
    assert train_block_kernel_launches(cfg, microbatches=mb, remat="full") == want
