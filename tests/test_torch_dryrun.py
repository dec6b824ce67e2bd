"""The dry runs (repro_torch.launch.dryrun / dryrun_spmv) against the JAX
package's, and the count they rest on.

* ``abstract_params`` and ``input_specs`` give the reference's shapes and
  dtypes leaf for leaf, for every registered arch at full width (decode
  caches included); nothing is allocated.
* ``_opt_cfg`` / ``_microbatches`` and ``synth_partition_1d`` equal the
  reference's, which run in tests/_torch_mesh_runner.py (case "dryrun"):
  importing ``repro.launch.dryrun`` sets XLA_FLAGS, so it owns a process.
* At reduced width, one config of each family with 3 repeats: the count
  on fake tensors equals the count of the same step on real CPU tensors
  (FLOPs and bytes), and the L=1 / L=2 probes extrapolate to the
  full-depth count.  sLSTM's stepped-once count plus
  ``slstm_scan_correction`` is the full loop's count.
* The SpMV dry run's programs at P = 4 parts on the CPU (1D with
  impl="cuda", so the COO kernel's plain version; the ring, bucketed)
  agree with a float64 oracle within 2e-4 and with the reference's
  programs; the ring's count from its steps equals its eager count.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro.models import lm as jlm
from repro.configs import get_config as jax_config
from repro_torch.analysis import roofline as R
from repro_torch.analysis.count import counting
from repro_torch.api import plan_from_partitioned
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import SHAPES
from repro_torch.core import distributed as D
from repro_torch.core.mesh import make_mesh
from repro_torch.launch import dryrun as DR
from repro_torch.launch import dryrun_spmv as DS
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (MODEL_PARALLEL, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.tree import leaves

from _torch_mesh_cases import BATCH, DRYRUN_SPMV, DRYRUN_SYNTH, PARTS, dryrun_x

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_configs()
# one config of each family, at reduced width with 3 repeats
FAMILIES = ["llama3.2-1b", "mixtral-8x22b", "deepseek-v3-671b", "zamba2-2.7b",
            "xlstm-1.3b", "seamless-m4t-medium"]
TINY = {"tiny_train": dict(seq_len=16, global_batch=2, kind="train"),
        "tiny_prefill": dict(seq_len=16, global_batch=2, kind="prefill")}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_runner.py"),
         str(out), "dryrun"], capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        pytest.fail(f"mesh runner crashed:\n{proc.stderr[-3000:]}")
    if "MESH SKIP" in proc.stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z)


def _jax_leaves(tree):
    """(path, shape, dtype) of every array leaf, ``length`` fields left out
    (a port cache keeps its length as an int)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if path and str(path[-1]).endswith("length"):
            continue
        out.append((tuple(leaf.shape), str(np.dtype(leaf.dtype))))
    return out


def _port_leaves(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_reference_leaf_for_leaf(arch):
    params = lm.abstract_params(get_config(arch))
    got = _port_leaves(params)
    assert got == _jax_leaves(jlm.abstract_params(jax_config(arch)))
    assert all(t.fake_mode is leaves(params)[0].fake_mode for t in leaves(params))
    if arch == "xlstm-1.3b":  # the tree, not ArchConfig.n_params (1.311e9)
        assert sum(int(np.prod(s)) for s, _ in got) == 959_547_392


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    for shape in SHAPES:
        got = S.input_specs(cfg, shape)
        want = JS.input_specs(ref, shape)
        assert sorted(got) == sorted(want), shape
        for key in want:
            assert _port_leaves(got[key]) == _jax_leaves(want[key]), (shape, key)


def test_abstract_state_holds_the_optimizers_moments():
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2)
    params, opt = S.abstract_state(cfg, DR._opt_cfg(cfg))
    assert _port_leaves(opt.m) == [(s, "float32") for s, _ in _port_leaves(params)]
    big = get_config("deepseek-v3-671b")
    _, opt = S.abstract_state(dataclasses.replace(big, n_layers=4),
                              DR._opt_cfg(big))
    assert {d for _, d in _port_leaves(opt.v)} == {"int8", "float32"}


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_cfg_and_microbatches_equal_the_reference(arch, jax_side):
    want = json.loads(str(jax_side["dryrun|settings"]))[arch]
    cfg = get_config(arch)
    assert dataclasses.asdict(DR._opt_cfg(cfg)) == want["opt"]
    assert {s: DR._microbatches(cfg, s) for s in SHAPES} == want["microbatches"]


def test_synth_partition_1d_equals_the_reference(jax_side):
    mat = DS.synth_partition_1d(DRYRUN_SYNTH["rows"], DRYRUN_SYNTH["cols"],
                                DRYRUN_SYNTH["nnz_per_row"], DRYRUN_SYNTH["parts"],
                                device="cpu")
    for f in ("rowind", "colind", "values", "nnz", "row_start", "col_start",
              "row_extent", "col_extent"):
        want = jax_side[f"dryrun|synth|{f}"]
        got = getattr(mat, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (mat.shape, mat.grid, mat.fmt, mat.scheme, mat.h_pad, mat.w_pad) == (
        (4096, 4096), (8, 1), "coo", "1d.nnz", 512, 4096)


def _f64(mat) -> np.ndarray:
    a = np.zeros(mat.shape)
    for p in range(mat.n_parts):
        n = int(mat.nnz[p])
        rows = mat.rowind[p, :n].numpy() + int(mat.row_start[p])
        np.add.at(a, (rows, mat.colind[p, :n].numpy()),
                  mat.values[p, :n].numpy().astype(np.float64))
    return a


@pytest.mark.parametrize("ring", [False, True], ids=["1d", "ring"])
def test_spmv_dry_run_programs_match_the_reference_and_float64(ring, jax_side):
    mat = DS.synth_partition_1d(DRYRUN_SPMV["rows"], DRYRUN_SPMV["cols"],
                                DRYRUN_SPMV["nnz_per_row"], PARTS, device="cpu")
    mesh = make_mesh((PARTS,), ("parts",), devices=["cpu"] * PARTS)
    if ring:
        part_r, counts = D.bucket_by_source_shard(mat, PARTS)
        exe = plan_from_partitioned(part_r, mesh, ring=True,
                                    ring_counts=counts).compile()
    else:
        exe = plan_from_partitioned(mat, mesh, impl="cuda").compile()
    x, X = dryrun_x()
    a = _f64(mat)
    name = "ring" if ring else "1d"
    for got, xin, key in ((exe(x), x, "y"), (exe.batch(X), X, "Y")):
        assert got.shape == (DRYRUN_SPMV["rows"],) + xin.shape[1:]
        np.testing.assert_allclose(got, a @ xin, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, jax_side[f"dryrun|{name}|{key}"],
                                   rtol=2e-4, atol=2e-4)
    assert BATCH == X.shape[1]


def test_the_rings_layout_and_its_count_from_steps():
    mat = DS.synth_partition_1d(1 << 11, 1 << 11, 16, PARTS, device="cpu")
    mesh = make_mesh((PARTS,), ("data",), devices=["cpu"] * PARTS)
    from repro_torch.analysis.count import fake_mode, fake_tree

    mode = fake_mode()
    part, counts = DS.ring_layout(mat, mode)
    real, want_counts = D.bucket_by_source_shard(mat, PARTS)
    np.testing.assert_array_equal(counts, want_counts)
    assert part.rowind.shape == real.rowind.shape and part.scheme == real.scheme
    stepped = DS.count_1d(mat, mesh, ring=True)
    plan = plan_from_partitioned(part, mesh, ring=True, ring_counts=counts)
    arrs = fake_tree(dict(D._arrays(part)), mode)
    x = fake_tree(torch.empty(plan._x_pad(part)), mode)
    program = plan.program(part)
    with mode, counting(arrs, x) as full:
        program(arrs, x)
    assert (stepped.flops, stepped.bytes, stepped.peak_bytes, stepped.ops,
            stepped.argument_bytes) == (full.flops, full.bytes, full.peak_bytes,
                                        full.ops, full.argument_bytes)
    # the 1D program's count: the COO kernel's nonzeros, x and y
    one = DS.count_1d(mat, mesh)
    nnz = (1 << 11) * 16
    assert one.kernel_flops == one.flops == 2 * nnz


def test_a_rank_of_the_reference_layout_counts_its_collectives():
    """count_rank: rank 0 of one rank per part, on fake tensors; its
    collectives counted by kind (x all-gathered, one split row permuted;
    the ring's P - 1 shards) and priced at the link rate."""
    from repro_torch.analysis.roofline import LINK_BW, CostTerms

    rows = 1 << 11
    mat = DS.synth_partition_1d(rows, rows, 16, PARTS, device="cpu")
    c, coll = DS.count_rank(mat)
    assert c.kernel_flops == c.flops == 2 * rows // PARTS * 16  # its part
    assert coll["bytes"] == {"all-gather": rows * 4, "all-reduce": 0,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 4}
    terms = CostTerms.from_counted(c, collectives=coll)
    assert terms.coll_bytes == rows * 4 + 4
    assert CostTerms.from_counted(c).coll_bytes == 0  # one card
    _, ring = DS.count_rank(mat, ring=True)
    assert ring["bytes"]["collective-permute"] == (PARTS - 1) * rows // PARTS * 4 + 4
    assert ring["calls"]["collective-permute"] == PARTS  # P - 1 shards, 1 row
    assert terms.coll_bytes / LINK_BW > 0


def test_the_meshes():
    """make_local_mesh without a world is the one-device (1, 1) mesh;
    make_production_mesh lays the reference's layout over a world of 256
    (512) ranks and raises without one, or with one of another size,
    naming the ranks it needs; it never falls back to one device."""
    from repro.launch import mesh as JM

    from repro_torch.core.world import World
    from repro_torch.launch.mesh import production_layout

    assert MODEL_PARALLEL == JM.MODEL_PARALLEL == 16
    mesh = make_local_mesh(4, device="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert mesh.device == torch.device("cpu")
    for multi_pod, ranks in ((False, 256), (True, 512)):
        with pytest.raises(NotImplementedError, match=f"{ranks} ranks"):
            make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(ValueError, match=f"{ranks} ranks"):
            make_production_mesh(World("dry", 0, 4, torch.device("cpu")),
                                 multi_pod=multi_pod)
        # the reference's layout (src/repro/launch/mesh.py), shape and names
        shape, axes = production_layout(multi_pod)
        assert shape == ((2, 16, 16) if multi_pod else (16, 16))
        assert axes == (("pod", "data", "model") if multi_pod else ("data", "model"))
        dry = make_production_mesh(World("dry", 3, ranks, torch.device("cpu")),
                                   multi_pod=multi_pod)
        assert dry.devices.shape == shape and dry.axis_names == axes
        assert dry.rank == 3
    with pytest.raises(NotImplementedError, match="Multi-card meshes"):
        DR.run_cell("llama3.2-1b", "train_4k", True, False, None)


def _family(arch, repeats=3):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(
        cfg, n_layers=len(cfg.prefix_pattern) + repeats * len(cfg.block_pattern))


def _real_inputs(cfg, shape):
    """Real CPU tensors of ``input_specs``' shapes and dtypes."""
    g = torch.Generator().manual_seed(7)

    def real(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, generator=g, dtype=torch.int32)
        return torch.randn(t.shape, generator=g).to(t.dtype)

    from repro_torch.tree import tree_map

    return tree_map(real, S.input_specs(cfg, shape))


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_fake_count_equals_the_count_of_real_tensors(arch, monkeypatch):
    for name, sh in TINY.items():
        monkeypatch.setitem(SHAPES, name, sh)
    cfg = _family(arch)
    fake = DR.count_cell(cfg, "tiny_train")
    opt_cfg = DR._opt_cfg(cfg)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    from repro_torch.optim import init_opt

    opt, batch = init_opt(params, opt_cfg), _real_inputs(cfg, "tiny_train")
    step = S.make_train_step(cfg, opt_cfg, donate=True)
    with DR._slstm_stepped_once(), counting(params, opt, batch) as real:
        step(params, opt, batch)
    assert fake.flops > 0 and fake.bytes > 0
    assert (fake.flops, fake.argument_bytes) == (real.flops, real.argument_bytes)
    assert fake.flops_by_op == real.flops_by_op
    if arch != "deepseek-v3-671b":
        assert fake.bytes == real.bytes
        return
    # MLA updates its score tensor in place (``_mla_attend``): on real CPU
    # tensors autograd replays that view through a zeroed buffer and a copy
    # (7 of each, one a layer), on fake ones it does not; every other op
    # moves the same bytes
    differ = {k for k in set(fake.bytes_by_op) | set(real.bytes_by_op)
              if fake.bytes_by_op[k] != real.bytes_by_op[k]}
    assert differ <= {"aten.copy_", "aten.new_zeros"}, differ
    assert fake.bytes == pytest.approx(real.bytes, rel=1e-2)


@pytest.mark.parametrize("arch,shape", [(a, "tiny_train") for a in FAMILIES]
                         + [("llama3.2-1b", "tiny_prefill")])
def test_the_probes_extrapolate_to_the_full_depth_count(arch, shape, monkeypatch):
    for name, sh in TINY.items():
        monkeypatch.setitem(SHAPES, name, sh)
    cfg = _family(arch)
    full = DR.count_cell(cfg, shape, donate=False, microbatches=1)
    probe = DR.probe_cell(cfg, shape)
    # both count sLSTM's loop stepped once; the probes add the rest
    corr = R.slstm_scan_correction(cfg, shape)
    assert (corr > 0) == (arch == "xlstm-1.3b")
    assert probe.flops - corr == pytest.approx(full.flops, rel=1e-12)
    assert probe.bytes_hbm == pytest.approx(full.bytes, rel=1e-12)


def test_slstm_stepped_once_plus_its_correction_is_the_full_loop(monkeypatch):
    for name, sh in TINY.items():
        monkeypatch.setitem(SHAPES, name, sh)
    cfg = _family("xlstm-1.3b")
    once = DR.count_cell(cfg, "tiny_prefill")
    params = lm.abstract_params(cfg)
    ins = S.input_specs(cfg, "tiny_prefill", mode=leaves(params)[0].fake_mode)
    with leaves(params)[0].fake_mode, counting(params, ins) as loop:
        S.make_prefill_step(cfg, "tiny_prefill")(params, ins)
    corr = R.slstm_scan_correction(cfg, "tiny_prefill")
    assert corr > 0 and once.flops + corr == loop.flops


def test_a_microbatched_step_is_counted_from_two_and_three(monkeypatch):
    """count_cell counts a step of m > 3 microbatches from steps of 2 and 3
    microbatches of the same size: equal to counting all m."""
    monkeypatch.setitem(SHAPES, "tiny_mb", dict(seq_len=16, global_batch=8,
                                                kind="train"))
    cfg = _family("mixtral-8x22b", repeats=2)
    direct = DR._count_step(cfg, "tiny_mb", True, 4)
    counted = DR.count_cell(cfg, "tiny_mb", microbatches=4)
    assert (counted.flops, counted.bytes, counted.ops, counted.argument_bytes) == \
        (direct.flops, direct.bytes, direct.ops, direct.argument_bytes)
    assert counted.flops_by_op == direct.flops_by_op
    assert counted.peak_bytes == pytest.approx(direct.peak_bytes, rel=0.05)
