"""Rank bodies of tests/test_torch_lm_mesh.py (numpy and torch only).

One gloo world of 4 CPU ranks per module (``repro_torch.core.world.
spawn``).  For every case of tests/_torch_lm_mesh_cases.py each rank
builds the port's process mesh, cuts the filled params (the same weights
as the JAX runner's) to its blocks through ``convert.lm_params(..., mesh)``
and runs ``lm.prefill`` and the decode steps under ``core.sharding.
set_mesh``; it returns its logits (its batch block, vocab whole), its
leaves' shapes and bytes, and the collectives it called.  The Server case
also runs ``Server(mesh=, params=).generate``; the MoE cases run
``moe_apply`` on the rank's batch block inside ``moe.dispatch_log``.
"""
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.core.collectives import Collectives
from repro_torch.core.mesh import make_process_mesh
from repro_torch.kernels import instrument
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.runtime.elastic import (make_shardings, sanitize_shardings,
                                         shard_tree, unshard_tree)
from repro_torch.sparse.layers import DERIVED, RUN, strip_derived
from repro_torch.tree import tree_map

from _torch_lm_mesh_cases import (DECODE_STEPS, LM_CASES, MAX_LEN, MOE_CASES,
                                  MOE_MESH, SERVER_CASE, SERVER_TOKENS, GLOO_CASES,
                                  _paths,
                                  config, fill, lm_inputs, moe_input)


def numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _leaf_shapes(tree) -> dict:
    return {p: tuple(a.shape) for p, a in _paths(tree)}


def lm_case(world, case_id, arch, shape, overrides, backend=False) -> dict:
    cfg = config(get_config, arch, overrides)
    mesh = make_process_mesh(world, shape, ("data", "model"))
    if backend:  # gloo's own collectives, as a mesh across hosts takes
        object.__setattr__(mesh, "collectives", Collectives(mesh))
    full = fill(numpy_tree(strip_derived(lm.init_params(
        torch.Generator().manual_seed(0), cfg, torch.float32))), 0)
    params = convert.lm_params(full, cfg, mesh)
    toks, steps = (torch.from_numpy(a) for a in lm_inputs(cfg))
    coll = SH.collectives(mesh)
    coll.reset()
    instrument.reset()
    out = {"coords": mesh.coords, "logits": []}
    with torch.no_grad(), SH.set_mesh(mesh):
        logits, caches = lm.prefill(params, toks, cfg, MAX_LEN)
        out["logits"].append(logits.numpy())
        out["prefill_coll"] = coll.snapshot()
        for i in range(DECODE_STEPS):
            logits, caches = lm.decode_step(params, steps[i], caches, cfg)
            out["logits"].append(logits.numpy())
    out["coll"] = coll.snapshot()
    out["caches"] = [tuple(c.shape) for c in caches.prefix[0][:-1]] \
        if caches.prefix else [tuple(c.shape) for c in caches.blocks["b0"][:-1]]
    reference = strip_derived(params)
    out["shapes"] = _leaf_shapes(numpy_tree(reference))
    out["bytes"] = sum(a.nbytes for _, a in _paths(numpy_tree(reference)))
    out["derived"] = sorted({p.rsplit("/", 1)[1] for p, _ in _paths(
        numpy_tree(params)) if p.rsplit("/", 1)[1] in DERIVED + (RUN,)})
    out["transport"] = coll.transport
    if case_id == SERVER_CASE and not backend:
        from repro_torch.launch.serve import Server

        # the full leaves gathered back from every rank's blocks
        sh = convert.param_shardings(cfg, mesh, reference)
        back = unshard_tree(reference, sh)
        out["unsharded_equal"] = all(
            torch.equal(a, torch.from_numpy(b)) for (_, a), (_, b) in
            zip(_paths(back), _paths(full)))

        srv = Server(cfg, MAX_LEN, mesh=mesh, params=tree_map(
            torch.from_numpy, full), dtype=torch.float32)
        out["tokens"] = srv.generate(toks.numpy(), SERVER_TOKENS)
    return out


def moe_case(world, case_id, arch, overrides) -> dict:
    cfg = config(get_config, arch, overrides)
    mesh = make_process_mesh(world, MOE_MESH, ("data", "model"))
    full = fill(numpy_tree(M.moe_init(torch.Generator().manual_seed(1), cfg,
                                      torch.float32)), 1)
    full = tree_map(torch.from_numpy, full)
    sh = sanitize_shardings(make_shardings(mesh, M.moe_spec(cfg)), full)
    params = shard_tree(full, sh)
    x = torch.from_numpy(moe_input(cfg))
    coll = SH.collectives(mesh)
    coll.reset()
    with torch.no_grad(), SH.set_mesh(mesh), SH.batch_scope(x.shape[0]), \
            M.dispatch_log() as log:
        y = M.moe_apply(params, SH.batch_shard(x), cfg)
    return {"coords": mesh.coords, "y": y.numpy(), "log": log,
            "coll": coll.snapshot(),
            "bytes": sum(a.nbytes for _, a in _paths(numpy_tree(params)))}


def lm_mesh_cases(world) -> dict:
    torch.set_num_threads(1)
    res = {}
    for case_id, arch, shape, overrides in LM_CASES:
        res[case_id] = lm_case(world, case_id, arch, shape, overrides)
        if case_id in GLOO_CASES:
            res[case_id + "|gloo"] = lm_case(world, case_id, arch, shape,
                                             overrides, backend=True)
    for case_id, arch, overrides in MOE_CASES:
        res[case_id] = moe_case(world, case_id, arch, overrides)
    return res
