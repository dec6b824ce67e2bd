"""Rank bodies of tests/test_torch_lm_mesh_train.py (numpy and torch only).

One gloo world of 4 CPU ranks per module (``repro_torch.core.world.
spawn``) runs :func:`train_cases`: for every case of
tests/_torch_lm_mesh_train_cases.py each rank cuts the filled f32 params
(the JAX runner's weights) to its blocks, takes the loss and its gradients
(``launch.steps.value_and_grad_trainable`` of ``lm.loss_fn``, then the
batch-axis sums of the replicated leaves) and one ``make_train_step`` step
under ``set_mesh``, and returns its blocks, its loss and the collectives
it called; then ``TrainLoop(mesh=)`` runs uninterrupted, with a failure
injected, and to the elastic checkpoint; then each differentiable move
alone.  A world of 2 ranks runs :func:`elastic_restore`: the checkpoint
restored onto ``rescale_mesh_shape(2, model_parallel=2)`` and trained on.
"""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.core.mesh import make_process_mesh
from repro_torch.core.sharding import P
from repro_torch.kernels import instrument
from repro_torch.launch import steps as S
from repro_torch.launch.train import TrainLoop
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, init_opt
from repro_torch.runtime.elastic import rescaled_mesh, unshard_tree
from repro_torch.sparse.layers import strip_derived
from repro_torch.tree import tree_map

from _torch_lm_mesh_cases import _paths, config, fill
from _torch_lm_mesh_train_cases import (B, CKPT_EVERY, ELASTIC_AT, ELASTIC_MP,
                                        ELASTIC_STEPS, FAIL_AT, LOOP_ARCH,
                                        LOOP_MESH, LOOP_SEQ, LOOP_STEPS, MOVE_MESH,
                                        MOVES, OPT, QUANT_CASE, TRAIN_CASES,
                                        move_arrays, train_batch)

AXES = ("data", "model")


def numpy_tree(tree) -> dict:
    """{path: a copy as numpy} (the loop updates its tensors in place)."""
    return {p: a.detach().cpu().numpy().copy() for p, a in _paths(tree)}


def full_params(cfg) -> dict:
    """The filled f32 params, the reference's tree (numpy)."""
    return fill(tree_map(lambda t: t.numpy(), strip_derived(lm.init_params(
        torch.Generator().manual_seed(0), cfg, torch.float32))), 0)


def train_case(world, case_id, arch, shape, overrides, mb) -> dict:
    cfg = config(get_config, arch, overrides)
    mesh = make_process_mesh(world, shape, AXES)
    params = convert.lm_params(full_params(cfg), cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    coll = SH.collectives(mesh)
    out = {"coords": mesh.coords}
    with SH.set_mesh(mesh):
        loss, grads = S.loss_and_grads(params, batch, cfg)
        out["loss"], out["grads"] = float(loss), numpy_tree(grads)
        opt_cfg = AdamWConfig(**OPT)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb)
        coll.reset()
        instrument.reset()
        new, _, metrics = step(params, init_opt(strip_derived(params), opt_cfg),
                               batch)
        out["coll"] = coll.snapshot()
        out["step_loss"] = float(metrics["loss"])
        out["params"] = numpy_tree(strip_derived(new))
        if case_id == QUANT_CASE:
            params = convert.lm_params(full_params(cfg), cfg, mesh)
            q_cfg = AdamWConfig(**OPT, quantized_v=True)
            step = S.make_train_step(cfg, q_cfg)
            coll.reset()
            new, opt, _ = step(params, init_opt(strip_derived(params), q_cfg), batch)
            out["quant_coll"] = coll.snapshot()
            out["quant_params"] = numpy_tree(strip_derived(new))
            out["quant_v"] = numpy_tree(opt.v)
    return out


def loop_on(mesh, ckpt_dir=None, ckpt_every=CKPT_EVERY, params=True) -> TrainLoop:
    cfg = config(get_config, LOOP_ARCH, {})
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
    return out


def elastic_restore(world, ckpt_root: str) -> dict:
    """The elastic checkpoint restored onto the rescaled mesh of this
    world, trained to ELASTIC_STEPS."""
    mesh = rescaled_mesh(world, AXES, model_parallel=ELASTIC_MP)
    loop = loop_on(mesh, f"{ckpt_root}/elastic", ckpt_every=10 ** 9, params=False)
    restored = loop.maybe_restore()
    return {"shape": tuple(mesh.devices.shape), "restored": restored,
            "step": loop.step, "losses": loop.run(ELASTIC_STEPS, log_every=0)}


def _move(name: str, mesh, x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """This rank's gradient of its input of one move, its cotangent from
    ``r`` (see the test for each move's global function)."""
    d, m = mesh.coords
    rank = mesh.rank
    xt = torch.from_numpy(x)
    c = torch.from_numpy(r[rank])
    whole = torch.from_numpy(r[2 * d])  # one cotangent per data group
    if name == "gather-model":
        inp = xt[:, m * 3:(m + 1) * 3].clone().requires_grad_()
        loss = (SH.gather_dim(inp, "model", 1) * whole).sum()
    elif name in ("gather-data-split", "gather-data-whole"):
        inp = xt[d * 2:(d + 1) * 2].clone().requires_grad_()
        with SH.batch_scope(4 if name.endswith("split") else 3):
            out = SH.gather_dim(inp, "data", 0)
        cot = c if name.endswith("split") else torch.from_numpy(r[m])
        loss = (out * cot).sum()
    elif name == "slice-model":
        inp = xt.clone().requires_grad_()
        loss = (SH.slice_dim(inp, "model", 1) * c[:, m * 3:(m + 1) * 3]).sum()
    elif name == "slice-data-split":
        inp = xt.clone().requires_grad_()
        with SH.batch_scope(4):
            out = SH.slice_dim(inp, "data", 0)
        loss = (out * c[d * 2:(d + 1) * 2]).sum()
    elif name == "psum-model":
        inp = (xt + rank).requires_grad_()
        loss = (SH.psum(inp, "model") * whole).sum()
    elif name == "psum-scatter-data":
        inp = (xt + rank).requires_grad_()
        loss = (SH.collectives().psum_scatter(inp, "data") * c[d * 2:(d + 1) * 2]).sum()
    elif name == "all-to-all-data":
        inp = (xt + rank).requires_grad_()
        out = SH.collectives().all_to_all(inp, "data", split_dim=0, concat_dim=1)
        loss = (out * c.reshape(2, 12)).sum()
    elif name == "reshard-data":
        inp = xt[d * 2:(d + 1) * 2].clone().requires_grad_()
        out = SH.reshard(inp, P("data"), P(None, "data"))
        loss = (out * c[:, d * 3:(d + 1) * 3]).sum()
    elif name == "model-in":
        inp = xt.clone().requires_grad_()
        loss = (SH.model_in(inp) * c).sum()
    else:
        raise ValueError(name)
    (g,) = torch.autograd.grad(loss, inp)
    return g.numpy()


def moves(world) -> dict:
    mesh = make_process_mesh(world, MOVE_MESH, AXES)
    with SH.set_mesh(mesh):
        return {name: _move(name, mesh, *move_arrays(name)) for name, _ in MOVES}


def train_cases(world, ckpt_root: str) -> dict:
    torch.set_num_threads(1)
    res = {case[0]: train_case(world, *case) for case in TRAIN_CASES}
    res["loops"] = loops(world, ckpt_root)
    res["moves"] = moves(world)
    return res


def elastic_world(world, ckpt_root: str) -> dict:
    torch.set_num_threads(1)
    return elastic_restore(world, ckpt_root)
