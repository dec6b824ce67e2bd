"""The recurrent kinds and the encoder-decoder on a process mesh: the
port's 4 gloo ranks against the JAX package's 4-device mesh.

One 4-rank gloo world on the CPU per module (bodies in
tests/_torch_lm_world_recurrent_runner.py) and, beside it, the JAX package
on 4 fake CPU devices in a subprocess
(tests/_torch_lm_mesh_recurrent_runner.py), on the cases of
tests/_torch_lm_mesh_recurrent_cases.py: the reduced zamba2 (Mamba2
blocks and the shared attention block) on (1, 4) and (2, 2), dense and
with the block-sparse FFN; the reduced xlstm (mLSTM and sLSTM) on (1, 4)
and (2, 2); the reduced seamless through the step builders on (2, 2)
(sparse, a vocab-parallel embedding) and on (1, 4) with a vocab of 258
(the embedding whole).  Both packages hold the same f32 weights.  Each
rank's prefill logits and 3 decode steps' (its batch block, every vocab
entry) must equal JAX's within 1e-5 of the largest |logit| (the sums run
in another order), and so must its final caches (its rows and heads:
recurrent states, KV caches) of JAX's within 1e-5 of their largest
entry.  Each rank's leaves have JAX's local shard shapes, its param bytes
and its collectives their closed forms (``analysis.sharded``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.world import spawn

from _torch_lm_mesh_recurrent_cases import (B, CASES, DECODE_STEPS, S, S_ENC,
                                            SERVER_CASE, config, heads_dim)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # of the largest entry: f32 sums in another order


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, every rank's results): the JAX runner runs in a
    subprocess while the 4 ranks run."""
    import _torch_lm_world_recurrent_runner as wr

    out = tmp_path_factory.mktemp("lm_mesh_recurrent") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_lm_mesh_recurrent_runner.py"),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    try:
        ranks = spawn(wr.cases, 4, "gloo", device="cpu", timeout=300)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        pytest.fail(f"recurrent mesh runner crashed:\n{stderr[-3000:]}")
    if "LM MESH SKIP" in stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z), ranks


def _rows(coords, shape):
    """The batch rows rank ``coords`` holds on a (data, model) mesh."""
    dd = shape[0]
    if B % dd:
        return slice(None)
    return slice(coords[0] * B // dd, (coords[0] + 1) * B // dd)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_rank_logits_match_the_jax_mesh(sides, case):
    jax_res, ranks = sides
    case_id, _, shape, _ = case
    names = ["prefill"] + [f"decode{i}" for i in range(DECODE_STEPS)]
    for rank in ranks:
        got = rank[case_id]
        rows = _rows(got["coords"], shape)
        for name, logits in zip(names, got["logits"]):
            want = jax_res[f"{case_id}|{name}"][rows]
            assert logits.shape == want.shape, (case_id, name)
            np.testing.assert_allclose(logits, want, rtol=0,
                                       atol=TOL * np.abs(want).max(),
                                       err_msg=f"{case_id} {name} {got['coords']}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_rank_caches_match_the_jax_mesh(sides, case):
    """Each rank's final caches (recurrent states, KV caches) are its rows
    and its heads of JAX's, and the ranks together cover every head."""
    jax_res, ranks = sides
    case_id, arch, shape, overrides = case
    cfg = config(get_config, arch, overrides)
    kinds = {f"b{j}": k for j, k in enumerate(cfg.block_pattern)}
    for key in ranks[0][case_id]["caches"]:
        block = key.split("|")[0]
        want = jax_res[f"{case_id}|cache|{key}"]
        hd = heads_dim(kinds[block])
        covered = np.zeros(want.shape[hd], bool)
        for rank in ranks:
            got = rank[case_id]
            local = got["caches"][key]
            n = local.shape[hd]
            start = got["coords"][1] * n if n < want.shape[hd] else 0
            covered[start:start + n] = True
            part = np.take(want[:, _rows(got["coords"], shape)],
                           np.arange(start, start + n), axis=hd)
            assert local.shape == part.shape, (case_id, key)
            np.testing.assert_allclose(local, part, rtol=0,
                                       atol=TOL * max(np.abs(want).max(), 1e-30),
                                       err_msg=f"{case_id} {key} {got['coords']}")
        assert covered.all(), (case_id, key)
        if kinds[block] in ("mamba", "mlstm", "slstm") and shape[1] > 1:
            assert n < want.shape[hd], (case_id, key)  # a rank holds its heads


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
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
        if cfg.ssm_heads and shape[1] > 1:  # Mamba2's in_proj is never whole
            d, di = cfg.d_model, cfg.ssm_d_inner
            w = got["shapes"]["/blocks/b0/mamba/in_proj/w"]
            assert w[-1] == 2 * di // shape[1] and w[-2] == d // shape[0]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_collectives_match_their_closed_forms(sides, case):
    """Every rank's collective calls and bytes, by kind, over its prefill
    and decode steps (and the encoder-decoder's two encoder passes: the
    prefill step's and the one whose memory the decode steps read)."""
    from repro_torch.analysis import sharded as SHD

    _, ranks = sides
    case_id, arch, shape, overrides = case
    cfg = config(get_config, arch, overrides)
    want = SHD.serve_collectives(cfg, shape, B, S, DECODE_STEPS, 4, S_mem=S_ENC)
    if cfg.encoder_layers:  # the prefill step's encoder pass and the decode memory's
        enc = SHD.encode_collectives(cfg, shape, B, S_ENC, 4)
        for part in ("calls", "bytes"):
            for kind, n in enc[part].items():
                want[part][kind] += 2 * n
    if cfg.ssm_heads and shape[1] > 1:  # one all-to-all a Mamba2 block a pass
        mamba = cfg.block_pattern.count("mamba") * cfg.n_repeats
        assert want["calls"]["all-to-all"] == mamba * (1 + DECODE_STEPS)
    for rank in ranks:
        got = rank[case_id]["coll"]
        assert got["calls"] == want["calls"], case_id
        assert got["bytes"] == want["bytes"], case_id
        if cfg.encoder_layers:  # the memory holds the rank's rows
            assert rank[case_id]["memory_rows"] == B // shape[0]


def test_server_on_a_mesh_generates_the_jax_greedy_tokens(sides):
    jax_res, ranks = sides
    want = jax_res[f"{SERVER_CASE}|tokens"]
    for rank in ranks:  # every rank returns the whole batch
        np.testing.assert_array_equal(rank[SERVER_CASE]["tokens"], want)


@pytest.mark.parametrize("rows, ok", [(2, True), (4, False)])
def test_the_memory_on_a_mesh_is_the_rank_rows_of_encode(rows, ok):
    """On a (2, 2) mesh a batch of 4 is split over "data": the decoder
    takes ``encode``'s output, the rank's 2 rows, and refuses the global
    memory."""
    from repro_torch.core import sharding as SH
    from repro_torch.core.mesh import dry_process_mesh
    from repro_torch.models.lm import _memory_rows

    memory = torch.zeros(rows, 3, 8)
    with SH.set_mesh(dry_process_mesh((2, 2), ("data", "model"))), SH.batch_scope(4):
        if ok:
            assert _memory_rows(memory, 4) is memory
        else:
            with pytest.raises(ValueError, match="lm.encode"):
                _memory_rows(memory, 4)
