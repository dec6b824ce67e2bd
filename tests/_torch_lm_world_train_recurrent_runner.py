"""Rank bodies of tests/test_torch_lm_mesh_train_recurrent.py (numpy and
torch only).

One gloo world of 4 CPU ranks per module (``repro_torch.core.world.
spawn``) runs :func:`train_cases`: for every case of
tests/_torch_lm_mesh_train_recurrent_cases.py each rank cuts the filled
f32 params (the JAX runner's weights) to its blocks, takes the loss and
its gradients (``launch.steps.loss_and_grads``) and one
``make_train_step`` step under ``set_mesh`` (the enc-dec arch's batch
carries its frames), and returns its blocks, its loss, the collectives it
called and its calls of the block kernel's wrapper (on the CPU it runs
the plain version, which counts no launch); then ``TrainLoop(mesh=)`` on
zamba2 runs uninterrupted, with a failure injected, and to the elastic
checkpoint, which the 4 ranks also restore onto (1, 4) and train on, and
xlstm's loop writes a checkpoint on (2, 2) that they restore onto (1, 4).
A world of 2 ranks runs :func:`elastic_world`: both checkpoints restored
onto ``rescale_mesh_shape(2, model_parallel=2)`` and trained on.
"""
import contextlib

import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.core.mesh import make_process_mesh
from repro_torch.launch import steps as S
from repro_torch.launch.train import TrainLoop
from repro_torch.optim import AdamWConfig, init_opt
from repro_torch.runtime.elastic import rescaled_mesh, unshard_tree
from repro_torch.sparse import layers as SL
from repro_torch.sparse.layers import strip_derived
from repro_torch.tree import tree_map

from _torch_lm_mesh_cases import config
from _torch_lm_mesh_train_recurrent_cases import (B, CASES, CKPT_EVERY, ELASTIC_AT,
                                                  ELASTIC_MP, ELASTIC_STEPS, FAIL_AT,
                                                  LOOP_ARCH, LOOP_MESH, LOOP_SEQ,
                                                  LOOP_STEPS, OPT, QUANT_CASE,
                                                  XLSTM_ARCH, XLSTM_AT, XLSTM_STEPS,
                                                  batch)
from _torch_lm_world_train_runner import full_params, numpy_tree

AXES = ("data", "model")


@contextlib.contextmanager
def kernel_calls():
    """A list that counts the block kernel wrapper's calls made by the
    sparse layers while this is open."""
    calls, wrapped = [], SL.bcoo_spmv

    def counted(*args, **kwargs):
        calls.append(1)
        return wrapped(*args, **kwargs)

    SL.bcoo_spmv = counted
    try:
        yield calls
    finally:
        SL.bcoo_spmv = wrapped


def train_case(world, case_id, arch, shape, overrides, mb) -> dict:
    cfg = config(get_config, arch, overrides)
    mesh = make_process_mesh(world, shape, AXES)
    params = convert.lm_params(full_params(cfg), cfg, mesh)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    coll = SH.collectives(mesh)
    out = {"coords": mesh.coords}
    with SH.set_mesh(mesh):
        loss, grads = S.loss_and_grads(params, b, cfg)
        out["loss"], out["grads"] = float(loss), numpy_tree(grads)
        opt_cfg = AdamWConfig(**OPT)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb)
        coll.reset()
        with kernel_calls() as calls:
            new, _, metrics = step(params, init_opt(strip_derived(params), opt_cfg), b)
        out["coll"] = coll.snapshot()
        out["kernel_calls"] = len(calls)
        out["step_loss"] = float(metrics["loss"])
        out["params"] = numpy_tree(strip_derived(new))
        if case_id == QUANT_CASE:
            params = convert.lm_params(full_params(cfg), cfg, mesh)
            q_cfg = AdamWConfig(**OPT, quantized_v=True)
            step = S.make_train_step(cfg, q_cfg)
            coll.reset()
            new, opt, _ = step(params, init_opt(strip_derived(params), q_cfg), b)
            out["quant_coll"] = coll.snapshot()
            out["quant_params"] = numpy_tree(strip_derived(new))
            out["quant_v"] = numpy_tree(opt.v)
    return out


def loop_on(mesh, ckpt_dir=None, ckpt_every=CKPT_EVERY, params=True,
            arch=LOOP_ARCH) -> TrainLoop:
    cfg = config(get_config, arch, {})
    loop = TrainLoop(cfg, AdamWConfig(**OPT), mesh=mesh, seq_len=LOOP_SEQ,
                     global_batch=B, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    if params:
        loop.init_state(params=tree_map(torch.from_numpy, full_params(cfg)))
    return loop


def loops(world, ckpt_root: str) -> dict:
    """``TrainLoop(mesh=)``: uninterrupted, with a failure injected at
    FAIL_AT, and writing the elastic checkpoint at ELASTIC_AT (then on to
    ELASTIC_STEPS without writing)."""
    mesh = make_process_mesh(world, LOOP_MESH, AXES)
    out = {"plain": loop_on(mesh).run(LOOP_STEPS, log_every=0)}
    faulty = loop_on(mesh, f"{ckpt_root}/fault")
    out["fault"] = faulty.run(LOOP_STEPS, log_every=0, fail_at={FAIL_AT})
    elastic = loop_on(mesh, f"{ckpt_root}/elastic", ckpt_every=ELASTIC_AT)
    out["elastic_head"] = elastic.run(ELASTIC_AT, log_every=0)
    out["elastic_state"] = {
        "params": numpy_tree(unshard_tree(strip_derived(elastic.params),
                                          elastic.p_sh)),
        "m": numpy_tree(unshard_tree(elastic.opt.m, elastic.p_sh))}
    elastic.ckpt_every = 10 ** 9
    out["elastic_tail"] = elastic.run(ELASTIC_STEPS, log_every=0)
    wide = loop_on(rescaled_mesh(world, AXES, model_parallel=4),
                   f"{ckpt_root}/elastic", ckpt_every=10 ** 9, params=False)
    out["elastic_1x4"] = {"restored": wide.maybe_restore(), "step": wide.step,
                          "losses": wide.run(ELASTIC_STEPS, log_every=0)}
    xl = loop_on(mesh, f"{ckpt_root}/xlstm", ckpt_every=XLSTM_AT, arch=XLSTM_ARCH)
    xl.run(XLSTM_AT, log_every=0)
    xl.ckpt_every = 10 ** 9
    out["xlstm_tail"] = xl.run(XLSTM_STEPS, log_every=0)
    out["xlstm_1x4"] = xlstm_restore(rescaled_mesh(world, AXES, model_parallel=4),
                                     ckpt_root)
    return out


def xlstm_restore(mesh, ckpt_root: str) -> dict:
    """xlstm's checkpoint (written on (2, 2) at XLSTM_AT) restored onto
    ``mesh``, trained to XLSTM_STEPS."""
    loop = loop_on(mesh, f"{ckpt_root}/xlstm", ckpt_every=10 ** 9, params=False,
                   arch=XLSTM_ARCH)
    restored = loop.maybe_restore()
    return {"shape": tuple(mesh.devices.shape), "restored": restored,
            "step": loop.step, "losses": loop.run(XLSTM_STEPS, log_every=0)}


def train_cases(world, ckpt_root: str) -> dict:
    torch.set_num_threads(1)
    res = {case[0]: train_case(world, *case) for case in CASES}
    res["loops"] = loops(world, ckpt_root)
    return res


def elastic_world(world, ckpt_root: str) -> dict:
    """The elastic checkpoint restored onto the rescaled mesh of this
    2-rank world, trained to ELASTIC_STEPS."""
    torch.set_num_threads(1)
    mesh = rescaled_mesh(world, AXES, model_parallel=ELASTIC_MP)
    loop = loop_on(mesh, f"{ckpt_root}/elastic", ckpt_every=10 ** 9, params=False)
    restored = loop.maybe_restore()
    return {"shape": tuple(mesh.devices.shape), "restored": restored,
            "step": loop.step, "losses": loop.run(ELASTIC_STEPS, log_every=0),
            "xlstm": xlstm_restore(mesh, ckpt_root)}
