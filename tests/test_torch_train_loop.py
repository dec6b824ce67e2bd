"""The port's training driver (``repro_torch.launch.train.TrainLoop``,
``main``) and runtime (checkpoints, fault tolerance) against the JAX
package, and the port's own mirrors of tests/test_checkpoint.py,
tests/test_fault.py and tests/test_system.py.

JAX runs ``TrainLoop`` on ``make_local_mesh()``, as its own tests do; both
loops start from the same float32 params, carried across by
``convert.lm_params``.  Loss trajectories agree within 1e-4 relative
(each step's sums in another order, compounded over 8 steps).
Checkpoints cross in both directions bit for bit: the two packages write
one format.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import steps as JS
from repro.launch import train as JTR
from repro.launch.mesh import make_local_mesh
from repro.models import lm as JLM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt as jinit_opt
from repro.optim import init_residual as jinit_residual
from repro.runtime import checkpoint as JCK
from repro.runtime.elastic import rescale_mesh_shape as j_rescale
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import train as TTR
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import init_opt as tinit_opt
from repro_torch.optim import init_residual as tinit_residual
from repro_torch.runtime import (FaultEvent, HealthMonitor, RescalePlan, RestartPolicy,
                                 latest_step, rescale_mesh_shape, restore_checkpoint,
                                 save_checkpoint)
from repro_torch.sparse.layers import strip_derived, with_row_pointer
from repro_torch.tree import leaves as tleaves

from _torch_common import np_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


def cfgs(arch="smollm-360m", sparse=False):
    jc = get_config(arch).reduced()
    if sparse:
        jc = dataclasses.replace(jc, ffn_density=0.5, sparse_block=(8, 16))
    return jc, tconfigs.ArchConfig(**dataclasses.asdict(jc))


def f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def jax_loop(jc, ckpt_dir=None, compress=False, ckpt_every=3, total=10):
    """A JAX TrainLoop started from float32 params."""
    loop = JTR.TrainLoop(jc, JAdamW(**dict(OPT, total_steps=total)), make_local_mesh(),
                         seq_len=32, global_batch=4, ckpt_dir=ckpt_dir,
                         ckpt_every=ckpt_every, compress_pod_grads=compress)
    loop.init_state()
    loop.params = f32(loop.params)
    loop.opt = jinit_opt(loop.params, loop.opt_cfg)
    if compress:
        loop.residual = jinit_residual(loop.params)
    return loop


def port_loop(tc, params=None, ckpt_dir=None, compress=False, ckpt_every=3, total=10):
    """A port TrainLoop on the CPU, from ``params`` (JAX's, as numpy) or
    its own seeded init."""
    loop = TTR.TrainLoop(tc, TAdamW(**dict(OPT, total_steps=total)), seq_len=32,
                         global_batch=4, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         compress_pod_grads=compress, device="cpu")
    loop.init_state()
    if params is not None:
        loop.params = convert.lm_params(jax.tree.map(np.asarray, params), tc)
        loop.opt = tinit_opt(strip_derived(loop.params), loop.opt_cfg)
        if compress:
            loop.residual = tinit_residual(strip_derived(loop.params))
    return loop


@pytest.mark.parametrize("arch,sparse,compress", [
    ("smollm-360m", False, False), ("smollm-360m", False, True),
    ("qwen1.5-0.5b", True, False)])
def test_train_loop_trajectory_matches_reference(arch, sparse, compress):
    """8 steps from the same f32 params: losses within 1e-4 relative."""
    jc, tc = cfgs(arch, sparse)
    jl = jax_loop(jc, compress=compress)
    params0 = jax.tree.map(np.asarray, jl.params)  # the step donates them
    want = jl.run(8, log_every=0)
    tl = port_loop(tc, params0, compress=compress)
    got = tl.run(8, log_every=0)
    assert tl.step == 8 and len(got) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _one_jax_step(jc, opt_cfg, dtype):
    params = JLM.init_params(jax.random.PRNGKey(0), jc, dtype)
    opt = jinit_opt(params, opt_cfg)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, jc.vocab, (2, 16)),
                       jnp.int32)
    return jax.jit(JS.make_train_step(jc, opt_cfg))(
        params, opt, {"tokens": toks, "labels": toks})[:2]


QUANT = dict(OPT, quantized_m=True, quantized_v=True)


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    """bf16 params of a sparse model and int8 moments after one JAX step:
    every leaf equal to the bit; the port rebuilds its derived keys."""
    jc, tc = cfgs("qwen1.5-0.5b", sparse=True)
    params, opt = _one_jax_step(jc, JAdamW(**QUANT), jnp.bfloat16)
    JCK.save_checkpoint(str(tmp_path), 1, (params, opt))
    loop = TTR.TrainLoop(tc, TAdamW(**QUANT), seq_len=16, global_batch=2,
                         ckpt_dir=str(tmp_path), device="cpu")
    assert loop.maybe_restore() and loop.step == 1
    got = tleaves((strip_derived(loop.params), loop.opt))
    want = jax.tree.leaves((params, opt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_array_equal(np_of(a), np_of(b))
    assert loop.params["embed"]["emb"].dtype == torch.bfloat16
    assert loop.opt.m["embed"]["emb"]["q"].dtype == torch.int8
    w = loop.params["blocks"]["b0"]["mlp"]["w_down"]
    assert torch.equal(w["browptr"], with_row_pointer(
        {k: w[k] for k in ("browind", "bcolind", "bvalues")}, jc.d_model)["browptr"])
    loop.run(2, log_every=0)  # and trains on from it
    assert loop.step == 2


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jc, tc = cfgs("qwen1.5-0.5b", sparse=True)
    params, opt = _one_jax_step(jc, JAdamW(**QUANT), jnp.bfloat16)
    loop = TTR.TrainLoop(tc, TAdamW(**QUANT), seq_len=16, global_batch=2,
                         ckpt_dir=str(tmp_path), device="cpu")
    loop.init_state()
    loop.run(1, log_every=0)
    loop.save()
    like = (JLM.init_params(jax.random.PRNGKey(1), jc), jinit_opt(params, JAdamW(**QUANT)))
    got, step = JCK.restore_checkpoint(str(tmp_path), like)
    assert step == 1
    want = tleaves((strip_derived(loop.params), loop.opt))
    assert len(jax.tree.leaves(got)) == len(want)
    for a, b in zip(jax.tree.leaves(got), want):
        assert np_of(a).dtype == np_of(b).dtype
        np.testing.assert_array_equal(np_of(a), np_of(b))
    assert got[1].v["blocks"]["b0"]["mlp"]["w_up"]["bvalues"]["q"].dtype == jnp.int8


def test_port_resumes_a_jax_run(tmp_path):
    """A JAX run checkpointed at step 6, resumed in the port: steps 7-10
    within 1e-4 of the uninterrupted JAX run."""
    jc, tc = cfgs()
    want = jax_loop(jc).run(10, log_every=0)
    jl = jax_loop(jc, ckpt_dir=str(tmp_path))
    jl.run(6, log_every=0)
    assert latest_step(str(tmp_path)) == 6
    tl = port_loop(tc, ckpt_dir=str(tmp_path))
    assert tl.maybe_restore() and tl.step == 6
    assert tl.params["embed"]["emb"].dtype == torch.float32  # the file's dtype
    got = tl.run(10, log_every=0)
    np.testing.assert_allclose(got, want[6:], rtol=1e-4)


# ------------------------------------------------ mirrors of the JAX tests


def test_roundtrip_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "bf": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
        .to(torch.bfloat16),
        "f32": torch.arange(10, dtype=torch.float32) / 7,
        "i8": torch.arange(-5, 5, dtype=torch.int8),
        "nested": {"step": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(str(tmp_path), 42, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 42
    for a, b in zip(tleaves(tree), tleaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # and in the reference's reader
    jgot, _ = JCK.restore_checkpoint(str(tmp_path), jax.tree.map(np_of, tree))
    for a, b in zip(tleaves(tree), jax.tree.leaves(jgot)):
        np.testing.assert_array_equal(np_of(a), np_of(b))


def test_latest_points_to_newest_complete(tmp_path):
    tree = {"x": torch.ones((4,))}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    assert latest_step(str(tmp_path)) == 2


def test_torn_write_is_invisible(tmp_path):
    """A crash mid-write (leftover .tmp dir) must not corrupt restore."""
    tree = {"x": torch.ones((4,))}
    save_checkpoint(str(tmp_path), 5, tree)
    os.makedirs(tmp_path / "step_000000009.tmp")
    (tmp_path / "step_000000009.tmp" / "leaf-000000.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 5
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 5
    assert torch.equal(got["x"], torch.ones(4))


def test_restore_missing_returns_none_and_mismatch_raises(tmp_path):
    got, step = restore_checkpoint(str(tmp_path / "nope"), {"x": torch.ones(1)})
    assert got is None and step is None
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"x": torch.ones(3), "y": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"x": torch.ones(4)})


@pytest.mark.parametrize("sparse", [False, True])
def test_exact_resume_training(tmp_path, sparse):
    """train(10) == train(6) + crash + restore + train(4), rtol 1e-5."""
    _, tc = cfgs("qwen1.5-0.5b" if sparse else "smollm-360m", sparse)
    a = port_loop(tc, ckpt_dir=str(tmp_path / "a"))
    losses_a = a.run(10, log_every=0)
    b = port_loop(tc, ckpt_dir=str(tmp_path / "b"))
    losses_b1 = b.run(6, log_every=0)
    b2 = port_loop(tc, ckpt_dir=str(tmp_path / "b"))
    assert b2.maybe_restore() and b2.step == 6
    losses_b2 = b2.run(10, log_every=0)
    np.testing.assert_allclose(losses_a, losses_b1 + losses_b2, rtol=1e-5)


def test_failure_injection_recovers(tmp_path, capsys):
    """An injected failure restores the checkpoint and replays; the final
    trajectory equals an uninterrupted run."""
    _, tc = cfgs()
    ref = port_loop(tc, ckpt_dir=str(tmp_path / "ref"), ckpt_every=4, total=12)
    ref_losses = ref.run(12, log_every=0)
    faulty = port_loop(tc, ckpt_dir=str(tmp_path / "faulty"), ckpt_every=4, total=12)
    faulty.save()  # step-0 checkpoint so the first injected fault can restore
    losses = faulty.run(12, log_every=0, fail_at={6, 9})
    assert faulty.step == 12
    assert len(losses) == 12 + 2 + 1  # steps 4-5 and 8 replayed
    np.testing.assert_allclose(losses[-3:], ref_losses[-3:], rtol=1e-5)
    assert capsys.readouterr().out.count("[fault]") == 2


def test_failure_without_checkpoints_raises():
    _, tc = cfgs()
    loop = port_loop(tc)
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        loop.run(3, log_every=0, fail_at={1})


def test_persistent_failure_raises_after_the_policys_retries(tmp_path, capsys):
    """A step that fails every time is restored and retried as often as the
    policy allows, then raised: one device has no smaller mesh."""
    _, tc = cfgs()
    loop = port_loop(tc, ckpt_dir=str(tmp_path), ckpt_every=2)
    loop.run(2, log_every=0)
    step_fn, calls = loop.step_fn, []

    def failing(*a):
        if loop.step == 3:
            calls.append(loop.step)
            raise RuntimeError("device lost")
        return step_fn(*a)

    loop.step_fn = failing
    with pytest.raises(RuntimeError, match="device lost"):
        loop.run(5, log_every=0)
    retries = loop.policy.max_retries_per_step
    assert len(calls) == retries + 1 and loop.step == 3
    assert capsys.readouterr().out.count("[fault]") == retries


def test_monitor_detects_dead_host():
    mon = HealthMonitor(n_hosts=4, heartbeat_timeout_s=10)
    for h in range(3):  # host 3 never beats
        mon.beat(h, step=1, step_time_s=1.0, now=100.0)
    events = mon.check(step=2, now=105.0)
    dead = [e for e in events if e.kind == "dead"]
    assert [e.host for e in dead] == [3]
    assert dead[0] == FaultEvent("dead", 3, 2, "heartbeat timeout")


def test_monitor_detects_straggler():
    mon = HealthMonitor(n_hosts=4, min_history=8)
    for step in range(10):
        for h in range(4):
            mon.beat(h, step, 1.0 if h != 2 else 3.0, now=float(step))
    events = mon.check(step=10, now=10.0)
    assert [e.host for e in events if e.kind == "straggler"] == [2]


def test_restart_policy_escalates():
    pol = RestartPolicy(max_retries_per_step=2)
    assert [pol.on_failure(7) for _ in range(3)] == ["restore", "restore", "rescale"]


@pytest.mark.parametrize("n,axes,mp", [(8, ("data", "model"), 2), (6, ("data", "model"), 2),
                                       (512, ("pod", "data", "model"), 16),
                                       (5, ("data", "model"), None)])
def test_rescale_mesh_shape_matches_reference(n, axes, mp):
    assert rescale_mesh_shape(n, axes, mp) == j_rescale(n, axes, mp)
    plan = RescalePlan((8, 2), rescale_mesh_shape(n, axes, mp), axes, "host lost")
    assert plan.new_shape == j_rescale(n, axes, mp)


def test_training_learns_planted_structure():
    """tests/test_system.py's bound, in the port: 60 steps of the reduced
    model cut the loss by more than 1.0."""
    cfg = tconfigs.get_config("smollm-360m").reduced()
    loop = TTR.TrainLoop(cfg, TAdamW(lr_peak=3e-3, warmup_steps=10, total_steps=60),
                         seq_len=64, global_batch=8, device="cpu")
    loop.init_state()
    losses = loop.run(60, log_every=0)
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


# ------------------------------------------------ entry points


def test_train_loop_defaults_to_the_card(monkeypatch):
    _, tc = cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TTR.TrainLoop(tc, TAdamW(**OPT), seq_len=8, global_batch=2)


def test_main_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device",
         "cpu", "--steps", "4", "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout


def test_main_resumes_from_its_checkpoints(tmp_path, capsys):
    args = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = TTR.main(args + ["--steps", "4"])
    assert len(first) == 4 and latest_step(str(tmp_path)) == 4
    again = TTR.main(args + ["--steps", "6", "--resume"])
    assert len(again) == 2 and latest_step(str(tmp_path)) == 6
    assert "final loss" in capsys.readouterr().out
    assert all(np.isfinite(first + again))
