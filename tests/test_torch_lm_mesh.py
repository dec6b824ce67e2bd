"""The LMs on a process mesh: the port's 4 gloo ranks against the JAX
package's 4-device mesh.

One 4-rank gloo world on the CPU per module (bodies in
tests/_torch_lm_world_runner.py) and, beside it, the JAX package on 4 fake
CPU devices in a subprocess (tests/_torch_lm_mesh_runner.py), on the cases
of tests/_torch_lm_mesh_cases.py: the reduced qwen1.5 on (1, 4) and
(2, 2), dense and with the block-sparse FFN; the reduced deepseek-v3 with
64 experts (the reference's expert-parallel branch: d-sharded dispatch,
two all-to-alls, G = 2 dispatch groups) and its sparse prefix FFN on (2,
2); the reduced mixtral on (2, 2) (tokens stay, experts' d gathered).
Both packages hold the same f32 weights.  Each rank's prefill logits and
3 decode steps' (its batch block, every vocab entry) must equal JAX's
``lm.prefill`` / ``lm.decode_step`` under ``set_mesh`` within 1e-5 of the
largest |logit| (the sums run in another order); each rank's leaves have
JAX's local shard shapes and its param bytes their closed form
(``analysis.sharded.param_bytes``).  The MoE layers alone, with capacity
cut so assignments drop, keep exactly the assignments JAX's per-group
dispatch keeps, group by group, and their outputs agree.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.world import spawn

from _torch_lm_mesh_cases import (B, LM_CASES, MOE_CASES, MOE_MESH, MOE_SHAPE,
                                  SERVER_CASE, GLOO_CASES, config)

# every case with the mesh's own collectives (the ranks share one host: the
# data moves through shared memory), and GLOO_CASES again over gloo's own
# collectives: (case, key of the rank results)
RUNS = tuple((c, c[0]) for c in LM_CASES) + tuple(
    (c, c[0] + "|gloo") for c in LM_CASES if c[0] in GLOO_CASES)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # of max |logit|: f32 sums in another order


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, every rank's results): the JAX runner runs in a
    subprocess while the 4 ranks run."""
    import _torch_lm_world_runner as wr

    out = tmp_path_factory.mktemp("lm_mesh") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_lm_mesh_runner.py"),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    try:
        ranks = spawn(wr.lm_mesh_cases, 4, "gloo", device="cpu", timeout=300)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        pytest.fail(f"LM mesh runner crashed:\n{stderr[-3000:]}")
    if "LM MESH SKIP" in stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z), ranks


def _rows(coords, shape, n=B):
    """The batch rows rank ``coords`` holds on a (data, model) mesh."""
    dd = shape[0]
    if n % dd:
        return slice(None)
    return slice(coords[0] * n // dd, (coords[0] + 1) * n // dd)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r[1])
def test_rank_logits_match_the_jax_mesh(sides, run):
    jax_res, ranks = sides
    (case_id, _, shape, _), key = run
    steps = ["prefill"] + [f"decode{i}" for i in range(3)]
    for rank in ranks:
        got = rank[key]
        assert got["transport"] == ("gloo" if key.endswith("|gloo") else "shm")
        rows = _rows(got["coords"], shape)
        for step, logits in zip(steps, got["logits"]):
            want = jax_res[f"{case_id}|{step}"][rows]
            assert logits.shape == want.shape, (key, step)
            scale = np.abs(want).max()
            np.testing.assert_allclose(logits, want, rtol=0, atol=TOL * scale,
                                       err_msg=f"{key} {step} {got['coords']}")


@pytest.mark.parametrize("case", LM_CASES, ids=lambda c: c[0])
def test_each_rank_holds_only_its_blocks(sides, case):
    from repro_torch.analysis.sharded import param_bytes

    jax_res, ranks = sides
    case_id, arch, shape, overrides = case
    cfg = config(get_config, arch, overrides)
    for rank in ranks:
        got = rank[case_id]
        for path, s in got["shapes"].items():
            assert s == tuple(jax_res[f"{case_id}|shard|{path}"]), (case_id, path)
        assert got["bytes"] == param_bytes(cfg, shape, torch.float32), case_id
        if cfg.ffn_density < 1:
            assert got["derived"] == ["browptr", "brun", "t_bcolind",
                                      "t_browind", "t_browptr", "t_perm"]


def test_server_on_a_mesh_generates_the_jax_greedy_tokens(sides):
    jax_res, ranks = sides
    want = jax_res[f"{SERVER_CASE}|tokens"]
    for rank in ranks:  # every rank returns the whole batch
        np.testing.assert_array_equal(rank[SERVER_CASE]["tokens"], want)
        # and the ranks' blocks gather back to the full leaves, bit for bit
        assert rank[SERVER_CASE]["unsharded_equal"]


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c[0])
def test_moe_groups_drop_what_the_reference_drops(sides, case):
    jax_res, ranks = sides
    case_id, arch, overrides = case
    cfg = config(get_config, arch, overrides)
    kept = jax_res[f"{case_id}|kept"]
    assert kept.sum() < MOE_SHAPE[0] * MOE_SHAPE[1] * cfg.moe_top_k  # drops happen
    for rank in ranks:
        got = rank[case_id]
        (rec,) = got["log"]  # one group per rank: its data coordinate's
        g = got["coords"][0]
        assert rec["group"] == g and rec["groups"] == MOE_MESH[0]
        assert rec["kept"] == kept[g] and rec["dropped"] == rec["assigned"] - kept[g]
        want = jax_res[f"{case_id}|y"][_rows(got["coords"], MOE_MESH, MOE_SHAPE[0])]
        np.testing.assert_allclose(got["y"], want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=case_id)


@pytest.mark.parametrize("run", RUNS + tuple(((c[0], c[1], MOE_MESH, c[2]), c[0])
                                              for c in MOE_CASES),
                         ids=lambda r: r[1])
def test_collectives_match_their_closed_forms(sides, run):
    """Every rank's collective calls and bytes, by kind, over its prefill
    and decode steps (or the MoE layer alone), over gloo and over shared
    memory alike."""
    from repro_torch.analysis import sharded as SHD

    _, ranks = sides
    (case_id, arch, shape, overrides), key = run
    cfg = config(get_config, arch, overrides)
    if case_id.startswith("moe"):
        want = SHD.moe_collectives(cfg, shape, MOE_SHAPE[0], MOE_SHAPE[1], 4)
    else:
        want = SHD.serve_collectives(cfg, shape, B, 16, 3, 4)
    for rank in ranks:
        got = rank[key]["coll"]
        assert got["calls"] == want["calls"], case_id
        assert got["bytes"] == want["bytes"], case_id


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_training_on_a_mesh_that_splits_a_head_raises(arch):
    """The recurrent kinds train on a mesh (tests/test_torch_lm_mesh_train_
    recurrent.py), a rank running whole heads: where "model" does not
    divide the 4 heads of the reduced arch, ``lm.loss_fn`` raises
    ``NotImplementedError``; a head is never split or silently
    replicated."""
    from repro_torch import convert
    from repro_torch.core import sharding as SH
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.models import lm
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import tree_map

    cfg = get_config(arch).reduced()
    mesh = dry_process_mesh((1, 8), ("data", "model"))
    full = strip_derived(lm.init_params(torch.Generator().manual_seed(0), cfg,
                                        torch.float32))
    params = convert.lm_params(tree_map(lambda t: t.numpy(), full), cfg, mesh)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with SH.set_mesh(mesh), pytest.raises(NotImplementedError,
                                          match="4 heads .* 8 ranks of 'model'"):
        lm.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)


def test_train_loop_on_a_mesh_fails_for_the_encoder_decoder_as_on_one_device():
    """``TrainLoop`` makes no frames, on one device or on a mesh, as the
    reference's: its first seamless step fails with the same KeyError in
    both (the step builders train seamless, its batch carrying frames)."""
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.sparse.layers import strip_derived

    cfg = get_config("seamless-m4t-medium").reduced()
    full = strip_derived(lm.init_params(torch.Generator().manual_seed(0), cfg,
                                        torch.float32))
    errors = []
    for kw in (dict(device="cpu"), dict(mesh=dry_process_mesh((2, 2),
                                                              ("data", "model")))):
        loop = TrainLoop(cfg, AdamWConfig(), seq_len=8, global_batch=2, **kw)
        loop.init_state(params=full)
        with pytest.raises(KeyError) as err:
            loop.run(1, log_every=0)
        errors.append(err.value.args)
    assert errors == [("frames",), ("frames",)]


def test_server_on_a_mesh_refuses_the_encoder_decoder_as_on_one_device():
    """Server passes no encoder memory, on a mesh as on one device: the
    same ValueError, naming the step builders that serve it."""
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.launch.serve import Server

    cfg = get_config("seamless-m4t-medium").reduced()
    with pytest.raises(ValueError, match="encoder-decoder") as one:
        Server(cfg, 16, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="encoder-decoder") as meshed:
        Server(cfg, 16, mesh=dry_process_mesh((2, 2), ("data", "model")),
               dtype=torch.float32)
    assert str(meshed.value) == str(one.value)
    assert "make_prefill_step" in str(one.value)
