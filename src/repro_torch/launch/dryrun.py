"""Dry run: count every (arch x shape) cell on the host, nothing allocated.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step for a 256- or 512-chip TPU mesh and reads XLA's
memory and cost analysis.  The port runs each cell's step once, eagerly,
on fake tensors (``FakeTensorMode`` on the CPU) under
:func:`repro_torch.analysis.count.counting`, at the cell's ``SHAPES``
batch and length, for one H100 (``chips = 1``, mesh ``"h100x1"``): FLOPs,
bytes, argument and temporary bytes.  Fake tensors lie on the CPU, so the
kernel wrappers take their plain versions and report the kernels' work.

Modes:
  full   (default)  count the step at full depth; records memory and cost.
  probe  (--probe)  also count L=1 and L=2 configs and extrapolate
                    (analysis/roofline.py), as the reference's probes do,
                    and write the roofline terms.

sLSTM's per-token loop is counted the reference's way: its time loop is
stepped once (``_slstm_stepped_once``) and ``slstm_scan_correction`` adds
the other S - 1 steps' FLOPs.  The GLA chunk loops are counted in full,
so ``gla_scan_correction`` is never added.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k [--probe] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probe
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

from repro_torch.analysis import roofline as R
from repro_torch.analysis.count import Count, counting, fake_mode
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import blocks
from repro_torch.models import linear_attn as LA
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig

__all__ = ["count_cell", "probe_cell", "run_cell", "main", "MESH", "CHIPS"]

MESH = "h100x1"
CHIPS = 1


def _opt_cfg(cfg):
    # 8-bit Adam moments for the largest model: 671B params leave no room for
    # f32 m/v on the reference's 256-chip pod (4 TB HBM total)
    big = cfg.name == "deepseek-v3-671b"
    return AdamWConfig(quantized_v=big, quantized_m=big)


def _microbatches(cfg, shape_name: str) -> int:
    # Bound the MoE dispatch working set (tokens*top_k slots) per device.
    if cfg.name == "deepseek-v3-671b" and shape_name == "train_4k":
        return 8
    if cfg.name == "mixtral-8x22b" and shape_name == "train_4k":
        return 2
    return 1


def _slstm_once(p, x, cfg):
    """``slstm_apply`` with its time loop stepped once: the input
    projection over every token, the cell at t = 0, its h repeated over
    the sequence, the output projection.  Shapes as ``slstm_apply``'s."""
    B, S_, d = x.shape
    H = cfg.n_heads
    pre = LA.dense_apply(p["w_in"], x).reshape(B, S_, H, 4 * (d // H))
    state = LA._slstm_cell(p, LA.slstm_zero_state(B, cfg, x.device), pre[:, 0])
    hs = state.h[:, None].expand((B, S_) + tuple(state.h.shape[1:]))
    return LA._xlstm_out(p, hs, x), state


@contextlib.contextmanager
def _slstm_stepped_once():
    """Run sLSTM blocks' full-sequence path through :func:`_slstm_once`
    while open (the dry run's count only; ``models/linear_attn.py`` is
    untouched)."""
    entry = blocks._RECURRENT["slstm"]
    blocks._RECURRENT["slstm"] = entry[:2] + (_slstm_once,) + entry[3:]
    try:
        yield
    finally:
        blocks._RECURRENT["slstm"] = entry


def _count_step(cfg, shape_name: str, donate: bool, microbatches: int,
                rows: int | None = None):
    """Count one step of the cell on fake tensors, on its first ``rows``
    rows of the batch (all by default)."""
    kind = SHAPES[shape_name]["kind"]
    mode = fake_mode()
    ins = S.input_specs(cfg, shape_name, mode=mode)
    if rows is not None:
        ins = {k: v[:rows] for k, v in ins.items()}
    if kind == "train":
        opt_cfg = _opt_cfg(cfg)
        params, opt = S.abstract_state(cfg, opt_cfg, mode=mode)
        fn = S.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                               donate=donate)
        args = (params, opt, ins)
    else:
        params = lm.abstract_params(cfg, mode=mode)
        fn = (S.make_prefill_step if kind == "prefill" else S.make_decode_step)(
            cfg, shape_name)
        args = (params, ins)
    with mode, _slstm_stepped_once(), counting(*args) as count:
        fn(*args)
    return count


def count_cell(cfg, shape_name: str, donate: bool = True, microbatches=None):
    """Count one cell's step on fake tensors; returns the
    :class:`~repro_torch.analysis.count.Count`.

    A train step of m > 3 microbatches runs the same value-and-grad and
    accumulation m times on B / m rows each, so it is counted from steps of
    2 and 3 microbatches of that size (the first 2B / m and 3B / m rows):
    FLOPs, bytes and ops are c2 + (m - 2) (c3 - c2), exactly; the peak is
    theirs (one microbatch's activations beside the accumulated grads).
    deepseek's train_4k (8 microbatches) then counts 5 value-and-grads, not
    8."""
    if microbatches is None:
        microbatches = _microbatches(cfg, shape_name)
    m = microbatches
    if SHAPES[shape_name]["kind"] != "train" or m <= 3:
        return _count_step(cfg, shape_name, donate, m)
    per = SHAPES[shape_name]["global_batch"] // m
    c2, c3 = (_count_step(cfg, shape_name, donate, k, rows=k * per)
              for k in (2, 3))
    out = Count(argument_bytes=c3.argument_bytes,
                peak_bytes=max(c2.peak_bytes, c3.peak_bytes),
                seconds=c2.seconds + c3.seconds)
    for f in ("flops", "bytes", "ops", "kernel_flops", "kernel_bytes",
              "plain_flops"):
        a, b = getattr(c2, f), getattr(c3, f)
        setattr(out, f, a + (m - 2) * (b - a))
    for f in ("flops_by_op", "bytes_by_op"):
        a, b = getattr(c2, f), getattr(c3, f)
        getattr(out, f).update({k: a[k] + (m - 2) * (b[k] - a[k]) for k in a | b})
    return out


def probe_cell(cfg, shape_name: str):
    """L=1 / L=2 probes -> extrapolated CostTerms, plus sLSTM's steps."""
    pre = len(cfg.prefix_pattern)
    pat = len(cfg.block_pattern)
    results = []
    for nr in (1, 2):
        probe_cfg = dataclasses.replace(
            cfg, n_layers=pre + pat * nr, unroll_layers=True
        )
        # probes run un-microbatched: same total tokens => same total costs
        results.append(R.CostTerms.from_counted(
            count_cell(probe_cfg, shape_name, donate=False, microbatches=1)))
    total = R.extrapolate(results[0], results[1], cfg.n_repeats)
    corr = R.slstm_scan_correction(cfg, shape_name)
    if corr:
        total = total.plus(R.CostTerms(
            flops=corr / CHIPS, notes=[f"slstm analytic +{corr:.3e} flops"]))
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, probe: bool,
             out_dir: str | None):
    cfg = get_config(arch)
    if shape_name in cfg.skip_shapes:
        print(f"[skip] {arch} x {shape_name}: inapplicable")
        return {"arch": arch, "shape": shape_name, "skipped": True}
    if multi_pod:
        make_production_mesh(multi_pod=True)  # raises: no world of 512 ranks
    label = f"{arch} x {shape_name} x {MESH}"
    count = count_cell(cfg, shape_name)
    corr = R.slstm_scan_correction(cfg, shape_name)
    print(f"[ok] {label} counted in {count.seconds:.1f}s ({count.ops} ops)")
    print(f"     memory: argument={count.argument_bytes:.4g} "
          f"temp={count.temp_bytes:.4g} bytes")
    print(f"     count: flops={count.flops + corr:.4g} bytes={count.bytes:.4g}")
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
        "chips": CHIPS,
        "compile_s": count.seconds,  # the count's wall s on the host
        "counted_on": "fake tensors (FakeTensorMode, CPU)",
        "memory": {
            "argument_bytes": count.argument_bytes,
            "temp_bytes": count.temp_bytes,
            "peak_estimate_bytes": count.peak_bytes,
        },
        "cost_raw": {
            "flops": float(count.flops + corr),
            "bytes": float(count.bytes),
            "kernel_flops": float(count.kernel_flops),
            "slstm_correction": corr,
        },
        "collectives": {k: 0 for k in ("all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute", "total")},
    }
    if probe:
        total = probe_cell(cfg, shape_name)
        rec["roofline"] = R.roofline_report(cfg, shape_name, CHIPS, total)
        rl = rec["roofline"]
        print(f"     roofline: compute={rl['compute_s']:.3e}s "
              f"memory={rl['memory_s']:.3e}s coll={rl['collective_s']:.3e}s "
              f"dominant={rl['dominant']} frac={rl['roofline_fraction']:.2%}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}_{shape_name}_{MESH}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true",
                    help="the reference's 512-chip mesh: raises (one card)")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON (incl. probe, if requested) exists")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    def _have(arch, shape_name):
        fn = os.path.join(args.out, f"{arch}_{shape_name}_{MESH}.json")
        if not os.path.exists(fn):
            return False
        if args.probe:
            with open(fn) as f:
                return "roofline" in json.load(f)
        return True

    if args.all:
        if args.multipod:
            make_production_mesh(multi_pod=True)
        t0 = time.perf_counter()
        failures = []
        for arch in list_configs():
            cfg = get_config(arch)
            for shape_name in cfg.shapes():
                if args.skip_existing and _have(arch, shape_name):
                    continue
                try:
                    run_cell(arch, shape_name, False, args.probe, args.out)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape_name, repr(e)))
                    traceback.print_exc()
        if failures:
            print(f"FAILURES ({len(failures)}):")
            for f in failures:
                print("  ", f)
            raise SystemExit(1)
        print(f"ALL CELLS GREEN in {time.perf_counter() - t0:.1f}s")
        return
    run_cell(args.arch, args.shape, args.multipod, args.probe, args.out)


if __name__ == "__main__":
    main()
