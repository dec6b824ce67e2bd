"""Training the LMs on a process mesh: the port's gloo ranks against the
JAX package's 4-device mesh.

One 4-rank gloo world on the CPU per module (bodies in
tests/_torch_lm_world_train_runner.py) and, beside it, the JAX package on 4
fake CPU devices in a subprocess (tests/_torch_lm_mesh_train_runner.py),
on the cases of tests/_torch_lm_mesh_train_cases.py: the reduced qwen1.5
on (1, 4) and (2, 2), dense and with the block-sparse FFN; the reduced
deepseek-v3 with 64 experts (the all-to-all branch, its sparse MLA prefix
layer and the MTP loss) on (2, 2); the reduced mixtral on (2, 2) with 2
microbatches.  Both packages hold the same f32 weights and batch.

For each case: the loss within 1e-5 relative of JAX's
``_value_and_grad_trainable(lm.loss_fn)`` under ``set_mesh``; each rank's
block of every gradient leaf within 1e-4 of the JAX leaf's max |g|; after
one ``make_train_step`` step each rank's param blocks within 1e-5 of the
leaf's max |p| wherever |g| > 1e-3 · max |g| (at step 1 AdamW moves a
parameter by about ±lr·sign(g): a gradient that is zero but for rounding,
as a key bias's is, flips its sign between two summation orders, a 2·lr
difference that says nothing); once with int8 second moments, their
scales within 1e-5 relative and their codes equal but at rounding ties;
each rank's collective calls and bytes by kind equal to
``analysis.sharded.train_collectives``.  ``TrainLoop(mesh=)`` on (2, 2)
recovers from an injected failure to the uninterrupted run's losses, which
are JAX's ``TrainLoop``'s within 1e-5; a checkpoint written on (2, 2)
restores onto the 2-rank (1, 2) mesh and trains on within 1e-5 of the
4-rank run; checkpoints cross between the packages both ways; every
differentiable move alone has the gradient of its global function.
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
from _torch_lm_mesh_train_cases import (B, ELASTIC_AT, ELASTIC_MP, ELASTIC_STEPS,
                                        FAIL_AT, LOOP_ARCH, LOOP_STEPS, MOVES, OPT,
                                        QUANT_CASE, S, TRAIN_CASES, move_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_IDS = [c[0] for c in TRAIN_CASES]


# the JAX side in two processes: deepseek's jit alone takes as long as the rest
JAX_PARTS = ("deepseek-2x2-sparse", ",".join(
    [c[0] for c in TRAIN_CASES if not c[0].startswith("deepseek")] + ["loop"]))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, every rank's results, the 2-rank world's, the
    checkpoint directory): the JAX runners run in subprocesses while the
    ranks run."""
    import _torch_lm_world_train_runner as wr

    out_dir = tmp_path_factory.mktemp("lm_mesh_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_lm_mesh_train_runner.py"),
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


_SHARDINGS: dict = {}


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


def _case(case_id):
    return next(c for c in TRAIN_CASES if c[0] == case_id)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_loss_and_grads_match_the_jax_mesh(sides, case_id):
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
            tol = 1e-4 * max(np.abs(want).max(), 1e-30)
            err = _match(want, g, shs[path])
            assert err <= tol, (case_id, path, got["coords"], err, tol)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_one_train_step_matches_the_jax_mesh(sides, case_id):
    jax_res, ranks, _, _ = sides
    for rank in ranks:
        got = rank[case_id]
        shs = _shardings(case_id, got["coords"])
        np.testing.assert_allclose(got["step_loss"], float(jax_res[f"{case_id}|step_loss"]),
                                   rtol=1e-5)
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
    jax_res, ranks, _, _ = sides
    for rank in ranks:
        got = rank[QUANT_CASE]
        shs = _shardings(QUANT_CASE, got["coords"])
        for path, a in got["quant_v"].items():
            want = jax_res[f"{QUANT_CASE}|quant_v|{path}"]
            if path.endswith("/scale"):  # the whole leaf's max (1 - b2) g^2 / 127:
                # the largest gradient squared, its f32 sums in another order
                np.testing.assert_allclose(a, want, rtol=1e-5, err_msg=path)
                continue
            # the codes, on the param's block: equal but at rounding ties,
            # where f32 noise picks the neighbour
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
    step: the forward's, the recompute's, the transposes', the gradient
    sums and the clip's (and the int8 scales' all-gather)."""
    from repro_torch.analysis.sharded import train_collectives

    _, ranks, _, _ = sides
    base, _, quant = case_id.partition("|")
    _, arch, shape, overrides, mb = _case(base)
    cfg = config(get_config, arch, overrides)
    want = train_collectives(cfg, shape, B, S, cfg.remat, microbatches=mb,
                             quantized=bool(quant), itemsize=4)
    for rank in ranks:
        got = rank[base]["quant_coll" if quant else "coll"]
        assert got["calls"] == want["calls"], (case_id, got["calls"])
        assert got["bytes"] == want["bytes"], (case_id, got["bytes"])


def test_train_loop_on_a_mesh_recovers_and_matches_the_jax_loop(sides):
    """As tests/test_fault.py: a failure at step FAIL_AT restores the last
    checkpoint and replays to the uninterrupted run's losses, on every
    rank; those are JAX's TrainLoop's on its (2, 2) mesh within 1e-5."""
    jax_res, ranks, _, _ = sides
    want = jax_res["loop|losses"]
    for rank in ranks:
        plain, fault = rank["loops"]["plain"], rank["loops"]["fault"]
        assert len(plain) == LOOP_STEPS and np.all(np.isfinite(plain))
        # the replayed steps repeat from the checkpoint; the run ends equal
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


def _jax_like(opt_kw=OPT):
    """The JAX reference's (params, opt) template of the loop's config."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import lm as JLM
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import init_opt as jinit_opt

    cfg = config(jget, LOOP_ARCH, {})
    params = JLM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, (params, jinit_opt(params, JAdamW(**opt_kw)))


def test_port_mesh_checkpoint_restores_in_jax(sides):
    """The checkpoint the 4 ranks wrote (the full leaves, each written by
    one rank in turn) is the gathered state, bit for bit, read by JAX's
    restore_checkpoint."""
    import jax

    from repro.runtime import checkpoint as JCK

    _, ranks, _, out_dir = sides
    _, like = _jax_like()
    (params, opt), step = JCK.restore_checkpoint(str(out_dir / "elastic"), like)
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
    """JAX's TrainLoop on its (2, 2) mesh wrote full leaves; the port
    restores them onto each rank of a (2, 2) mesh as that rank's blocks."""
    from repro_torch.configs import get_config as tget
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.launch import steps as TS
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import restore_checkpoint
    from repro_torch.runtime.elastic import make_shardings, sanitize_shardings
    from repro_torch.tree import leaves, tree_map

    _, _, _, out_dir = sides
    cfg = config(tget, LOOP_ARCH, {})
    ckpt = str(out_dir / "jax_ckpt")
    full, step = restore_checkpoint(ckpt, _port_like(cfg))
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


def _port_like(cfg):
    from repro_torch.models import lm as TLM
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.sparse.layers import strip_derived

    params = strip_derived(TLM.init_params(torch.Generator().manual_seed(0), cfg,
                                           torch.float32))
    return params, init_opt(params, AdamWConfig(**OPT))


def _move_expected(name: str, rank: int) -> np.ndarray:
    """The gradient of each move's global function at rank (d, m) of a
    (2, 2) mesh: the cotangents ``r`` are per rank, shared over "model"
    (r[2 d]) or over "data" (r[m]) where the consumers are replicated
    there."""
    x, r = move_arrays(name)
    d, m = divmod(rank, 2)
    rows, cols = slice(d * 2, d * 2 + 2), slice(m * 3, m * 3 + 3)
    if name == "gather-model":  # x's column block of Σ x ⊙ r[2d]
        return r[2 * d][:, cols]
    if name == "gather-data-split":  # partial rows: Σ over the data ranks
        return (r[m] + r[2 + m])[rows]
    if name == "gather-data-whole":  # every rank all rows: r[m]'s rows
        return r[m][rows]
    if name == "slice-model":  # the two column blocks' cotangents, whole
        return np.concatenate([r[2 * d][:, :3], r[2 * d + 1][:, 3:]], axis=1)
    if name == "slice-data-split":  # this rank's rows, zeros beside them
        out = np.zeros_like(x)
        out[rows] = r[rank][rows]
        return out
    if name == "psum-model":
        return r[2 * d]
    if name == "psum-scatter-data":  # every rank's rows block: an all-gather
        return np.concatenate([r[m][0:2], r[2 + m][2:4]])
    if name == "all-to-all-data":  # block k of x went to position k
        out = np.zeros_like(x)
        for k in range(2):
            out[k * 2:(k + 1) * 2] = r[2 * k + m].reshape(2, 12)[:, d * 6:(d + 1) * 6]
        return out
    if name == "reshard-data":  # rows d of the column blocks' cotangents
        full = np.concatenate([r[m][:, 0:3], r[2 + m][:, 3:6]], axis=1)
        return full[rows]
    if name == "model-in":  # both "model" ranks' partial gradients
        return r[2 * d] + r[2 * d + 1]
    raise ValueError(name)


@pytest.mark.parametrize("move", [m for m, _ in MOVES])
def test_each_differentiable_move_alone(sides, move):
    _, ranks, _, _ = sides
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["moves"][move], _move_expected(move, rank),
                                      err_msg=f"{move} rank {rank}")


def test_a_runs_transposed_stream_indexes_its_own_rows():
    """Rank 1's run of w_gate on (1, 4): grad x on the run's Wᵀ stream
    (``with_derived(..., mesh)``) equals the densified run's Wᵀ·gy.  Wᵀ's
    block-columns are the run's block-rows counted from its first, as the
    forward's rows are."""
    from repro_torch.core import sharding as SH
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.models import lm as TLM
    from repro_torch.sparse.layers import RUN, _run_rows, strip_derived, with_derived

    from _torch_lm_mesh_cases import SPARSE

    cfg = config(get_config, "qwen1.5-0.5b", SPARSE)
    mesh = dry_process_mesh((1, 4), ("data", "model"), rank=1)
    full = strip_derived(TLM.init_params(torch.Generator().manual_seed(0), cfg,
                                         torch.float32))
    w = full["blocks"]["b0"]["mlp"]["w_gate"]
    from repro_torch.convert import shard_params

    local = with_derived(shard_params(full, cfg, mesh), cfg, mesh)
    p = {k: v[0] for k, v in local["blocks"]["b0"]["mlp"]["w_gate"].items()}
    rows, lo, code = p[RUN].tolist()
    assert lo == rows and code == 1  # rank 1 holds whole block-rows from lo
    r, c = cfg.sparse_block
    dense = torch.zeros(cfg.d_ff, cfg.d_model)
    for bi, bj, v in zip(w["browind"][0].tolist(), w["bcolind"][0].tolist(),
                         w["bvalues"][0]):
        dense[bi * r:(bi + 1) * r, bj * c:(bj + 1) * c] = v
    run = dense[lo * r:(lo + rows) * r]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    x.requires_grad_()
    gy = torch.from_numpy(rng.standard_normal((2, 8, rows * r)).astype(np.float32))
    with SH.set_mesh(mesh), SH.batch_scope(2):
        y, merge = _run_rows(p, x, cfg.d_ff)
        assert merge == "gather"
        (gx,) = torch.autograd.grad((y * gy).sum(), x)
    np.testing.assert_allclose(y.detach().numpy(), (x @ run.T).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), (gy @ run).numpy(), rtol=1e-5, atol=1e-5)
