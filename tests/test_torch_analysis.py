"""repro_torch.analysis against the JAX package's repro.analysis.

The roofline arithmetic (``model_flops``, the layer counts, the scan
corrections, ``CostTerms`` and ``extrapolate``) is pure arithmetic on the
same configs, so it must equal the reference's exactly, for every
registered arch and every shape.  ``roofline_report`` equals the
reference's once the reference's three constants are set to the port's
(H100) values.  The report's tables are equal strings for the same
records.  The count (``analysis/count.py``) gives the same numbers on fake
and on real tensors, and the kernel wrappers report their work whichever
path runs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import report as JREP
from repro.analysis import roofline as JR
from repro.configs import get_config as jax_config
from repro_torch.analysis import count as C
from repro_torch.analysis import report as REP
from repro_torch.analysis import roofline as R
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import instrument
from repro_torch.kernels.bcsr_spmv import bcoo_spmv
from repro_torch.kernels.coo_spmv import coo_spmv, plan_chunks
from repro_torch.kernels.ell_spmv import dense_to_ell, ell_spmv

ARCHS = list_configs()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_corrections_equal_the_reference(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    assert R._layer_counts(cfg) == JR._layer_counts(ref)
    for shape, sh in SHAPES.items():
        assert R.model_flops(cfg, shape) == JR.model_flops(ref, shape), shape
        assert R._model_flops(cfg, sh["seq_len"], sh["global_batch"],
                              sh["kind"]) == JR.model_flops(ref, shape)
        assert R.slstm_scan_correction(cfg, shape) == \
            JR.slstm_scan_correction(ref, shape), shape
        assert R.gla_scan_correction(cfg, shape) == \
            JR.gla_scan_correction(ref, shape), shape
        for window in (None, 16, 4096):
            assert R._attn_flops_per_layer(cfg, sh["seq_len"], sh["global_batch"],
                                           sh["kind"], window) == \
                JR._attn_flops_per_layer(ref, sh["seq_len"], sh["global_batch"],
                                         sh["kind"], window)
    assert R.GLA_CHUNK == JR.GLA_CHUNK


def _terms(rng, mod):
    return mod.CostTerms(*(float(v) for v in rng.uniform(0, 1e15, 3)),
                         notes=[f"n{rng.integers(100)}"])


def _fields(t) -> tuple:
    return t.flops, t.bytes_hbm, t.coll_bytes, t.notes


@pytest.mark.parametrize("seed", range(4))
def test_cost_terms_and_extrapolate_equal_the_reference(seed):
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = _terms(rng_p, R), _terms(rng_p, R)
    ja, jb = _terms(rng_j, JR), _terms(rng_j, JR)
    k = float(rng_p.uniform(0, 100))
    assert _fields(a.scaled(k)) == _fields(ja.scaled(k))
    assert _fields(a.plus(b)) == _fields(ja.plus(jb))
    for nr in (1, 3, 61):
        assert _fields(R.extrapolate(a, b, nr)) == _fields(JR.extrapolate(ja, jb, nr))
        assert _fields(R.extrapolate(b, a, nr)) == _fields(JR.extrapolate(jb, ja, nr))


def test_the_constants_are_the_h100s_and_the_reference_keeps_its_own():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (JR.PEAK_FLOPS, JR.HBM_BW, JR.LINK_BW) == (197e12, 819e9, 50e9)
    assert R._DTYPE_BYTES == JR._DTYPE_BYTES


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_report_equals_the_reference_at_the_ports_constants(arch, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JR, name, getattr(R, name))
    rng = np.random.default_rng(len(arch))
    for shape in get_config(arch).shapes():
        terms = [float(v) for v in rng.uniform(0, 1e16, 3)]
        for chips in (1, 256):
            got = R.roofline_report(get_config(arch), shape, chips,
                                    R.CostTerms(*terms, notes=["x"]))
            want = JR.roofline_report(jax_config(arch), shape, chips,
                                      JR.CostTerms(*terms, notes=["x"]))
            assert got == want, (shape, chips)
    zero = R.roofline_report(get_config(arch), "train_4k", 1, R.CostTerms())
    assert zero["useful_ratio"] == 0.0 and zero["roofline_fraction"] == 0.0


def _records():
    rng = np.random.default_rng(0)
    recs = [{"arch": "xlstm-1.3b", "shape": "long_500k", "skipped": True}]
    for arch, shape in (("smollm-360m", "train_4k"), ("mixtral-8x22b", "decode_32k"),
                        ("zamba2-2.7b", "prefill_32k")):
        terms = [float(v) for v in rng.uniform(0, 1e16, 3)]
        recs.append({
            "arch": arch, "shape": shape, "mesh": "h100x1", "chips": 1,
            "compile_s": float(rng.uniform(0, 300)),
            "memory": {"argument_bytes": int(rng.integers(1 << 40)),
                       "temp_bytes": int(rng.integers(1 << 40))},
            "collectives": {k: int(rng.integers(1 << 33)) for k in (
                "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")},
            "roofline": R.roofline_report(get_config(arch), shape, 1,
                                          R.CostTerms(*terms)),
        })
    recs.append(dict(recs[1], roofline=None))
    return recs


def test_report_tables_equal_the_reference():
    recs = _records()
    assert REP.dryrun_table(recs) == JREP.dryrun_table(recs)
    assert REP.roofline_table(recs) == JREP.roofline_table(recs)
    assert REP.dryrun_table(recs).count("\n") == 5  # header, rule, 4 cells
    assert REP.roofline_table(recs).count("\n") == 4  # 3 with a roofline


def test_report_loads_the_records_and_prints_both_tables(tmp_path, capsys):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert REP.load(str(tmp_path)) == JREP.load(str(tmp_path)) == recs
    REP.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert REP.dryrun_table(recs) in out and REP.roofline_table(recs) in out
    assert "counted on fake tensors" in out


# --------------------------------------------------------------- the count


def _step(a, b):
    c = torch.nn.functional.gelu(a @ b)
    loss = (c * c).sum()
    loss.backward()
    return loss


def test_a_count_is_the_same_on_fake_and_real_tensors():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(48, 32, generator=g, requires_grad=True)
    b = torch.randn(32, 40, generator=g)
    with C.counting(a, b) as real:
        _step(a, b)
    mode = C.fake_mode()
    fa, fb = C.fake_tree((a.detach(), b), mode)
    fa.requires_grad_()
    with mode, C.counting(fa, fb) as fake:
        _step(fa, fb)
    for c in (real, fake):
        assert c.flops == 2 * (2 * 48 * 32 * 40)  # the product and grad a
        assert c.flops_by_op == {"aten.mm": c.flops}
        assert c.argument_bytes == (48 * 32 + 32 * 40) * 4
        assert c.kernel_flops == c.plain_flops == 0
    assert (real.flops, real.bytes, real.peak_bytes, real.ops) == \
        (fake.flops, fake.bytes, fake.peak_bytes, fake.ops)
    # c (48, 40) and its gelu are alive together, at the least
    assert real.temp_bytes >= 2 * 48 * 40 * 4
    assert R.CostTerms.from_counted(real).flops == real.flops
    assert R.CostTerms.from_counted(real).coll_bytes == 0.0


def test_views_and_allocations_move_no_bytes():
    x = torch.zeros(64, 64)
    with C.counting(x) as c:
        y = x.view(4096).reshape(64, 64).t()
        z = torch.empty(64, 64)
        del y, z
    assert c.bytes == 0 and c.flops == 0
    with C.counting(x) as c:
        x.add(1.0)
    assert c.bytes == 2 * 64 * 64 * 4  # x read once, the sum written once


def _block_case(seed=0, r=8, c=16, brows=6, bcols=5, per=3, B=4):
    rng = np.random.default_rng(seed)
    browind = np.repeat(np.arange(brows), per).astype(np.int32)
    bcolind = np.concatenate([np.sort(rng.choice(bcols, per, replace=False))
                              for _ in range(brows)]).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal((len(browind), r, c)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((bcols * c, B)).astype(np.float32))
    return torch.from_numpy(browind), torch.from_numpy(bcolind), vals, x, brows * r


def test_the_block_kernels_work_is_what_its_plain_version_counts():
    browind, bcolind, vals, x, out_rows = _block_case()
    nb, r, c = vals.shape
    with C.counting(vals, x) as cnt:
        y = bcoo_spmv(browind, bcolind, vals, x, out_rows)
    assert cnt.kernel_flops == 2 * nb * r * c * x.shape[1]
    # FlopCounterMode's formula on the plain version's einsum agrees
    assert cnt.plain_flops == cnt.kernel_flops == cnt.flops
    assert cnt.kernel_bytes == (nb * (r * c * 4 + 4) + (out_rows // r + 1) * 4
                                + x.numel() * 4 + y.numel() * 4)
    # outside a count the wrappers record no work
    f0 = instrument.work()
    bcoo_spmv(browind, bcolind, vals, x, out_rows)
    assert instrument.work() == f0


def test_the_coo_and_ell_kernels_report_their_nonzeros_work():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((40, 30)).astype(np.float32)
    a[rng.random(a.shape) < 0.8] = 0
    nnz = int((a != 0).sum())
    ri, ci = np.nonzero(a)
    plan = plan_chunks(torch.from_numpy(ri.astype(np.int32)),
                       torch.from_numpy(ci.astype(np.int32)),
                       torch.from_numpy(a[ri, ci]), 40, chunk=16, span=8)
    x = torch.from_numpy(rng.standard_normal((30, 3)).astype(np.float32))
    with C.counting(x) as cnt:
        y = coo_spmv(plan, x)
    assert cnt.kernel_flops == cnt.flops == 2 * nnz * 3
    assert cnt.kernel_bytes == nnz * 12 + x.numel() * 4 + 40 * 3 * 4
    np.testing.assert_allclose(y.numpy(), a @ x.numpy(), rtol=1e-5, atol=1e-5)
    colind, values, row_nnz = dense_to_ell(a)
    with C.counting(x) as cnt:
        ell_spmv(colind, values, row_nnz, x)
    assert cnt.kernel_flops == cnt.flops == 2 * nnz * 3
    # on fake tensors the COO wrapper reports its padded slots (no data)
    mode = C.fake_mode()
    fplan = dataclasses.replace(plan, **C.fake_tree(
        {f: getattr(plan, f) for f in plan._tensors}, mode))
    fx = C.fake_tree(x, mode)
    with mode, C.counting(fx) as cnt:
        fy = coo_spmv(fplan, fx)
    assert fy.shape == y.shape and fy.dtype == y.dtype
    assert cnt.kernel_flops == 2 * plan.values.numel() * 3 >= 2 * nnz * 3


@pytest.mark.parametrize("kernel", ["coo", "bcoo", "ell"])
def test_the_kernels_refuse_a_fake_cuda_tensor(kernel):
    """A fake tensor on "cuda" has no memory: every wrapper raises before
    reading a pointer, and none falls back to its plain version."""
    browind, bcolind, vals, x, out_rows = _block_case()
    mode = C.fake_mode()
    x = C.fake_tree(x, mode, device="cuda")
    with pytest.raises(TypeError, match="fake tensor"):
        if kernel == "bcoo":
            bcoo_spmv(browind, bcolind, C.fake_tree(vals, mode, device="cuda"), x,
                      out_rows)
        elif kernel == "coo":
            plan = plan_chunks(browind, bcolind, vals[:, 0, 0], out_rows)
            coo_spmv(dataclasses.replace(plan, **C.fake_tree(
                {f: getattr(plan, f) for f in plan._tensors}, mode,
                device="cuda")), x)
        else:
            colind, values, row_nnz = dense_to_ell(np.eye(out_rows, x.shape[0],
                                                          dtype=np.float32))
            ell_spmv(*C.fake_tree((colind, values, row_nnz), mode, device="cuda"),
                     x)
