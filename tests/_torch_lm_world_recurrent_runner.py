"""Rank bodies of tests/test_torch_lm_mesh_recurrent.py (numpy and torch).

One gloo world of 4 CPU ranks per module (``repro_torch.core.world.
spawn``).  For every case of tests/_torch_lm_mesh_recurrent_cases.py each
rank builds the port's process mesh, cuts the filled params (the JAX
runner's weights) to its blocks through ``convert.lm_params(..., mesh)``
and, under ``core.sharding.set_mesh``, runs ``lm.prefill`` and 3
``lm.decode_step``s, or for the encoder-decoder the step builders with the
memory of ``lm.encode`` (the rank's rows).  It returns its logits (its
batch block, every vocab entry), its final caches (its rows and heads),
its leaves' shapes and bytes and the collectives it called.  The Server
case also runs ``Server(mesh=, params=).generate``.
"""
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import sharding as SH
from repro_torch.core.mesh import make_process_mesh
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.sparse.layers import DERIVED, RUN, strip_derived
from repro_torch.tree import tree_map

from _torch_lm_mesh_recurrent_cases import (CASES, DECODE_STEPS, SERVER_CASE,
                                            SERVER_TOKENS, SHAPE, SHAPE_ENTRY,
                                            _paths, config, fill, frames,
                                            lm_inputs)


def numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def case(world, case_id, arch, shape, overrides) -> dict:
    cfg = config(get_config, arch, overrides)
    mesh = make_process_mesh(world, shape, ("data", "model"))
    full = fill(numpy_tree(strip_derived(lm.init_params(
        torch.Generator().manual_seed(0), cfg, torch.float32))), 0)
    params = convert.lm_params(full, cfg, mesh)
    toks, dec = (torch.from_numpy(a) for a in lm_inputs(cfg))
    coll = SH.collectives(mesh)
    coll.reset()
    out = {"coords": mesh.coords, "logits": []}
    with torch.no_grad(), SH.set_mesh(mesh):
        if cfg.encoder_layers:
            fr = torch.from_numpy(frames(cfg))
            memory = lm.encode(params, fr, cfg)
            out["memory_rows"] = memory.shape[0]
            logits, caches = steps.make_prefill_step(cfg, SHAPE)(
                params, {"tokens": toks, "frames": fr})
            step = steps.make_decode_step(cfg, SHAPE)

            def decode(t, c):
                return step(params, {"token": t, "caches": c, "memory": memory})
        else:
            logits, caches = lm.prefill(params, toks, cfg, SHAPE_ENTRY["seq_len"])

            def decode(t, c):
                return lm.decode_step(params, t, c, cfg)
        out["logits"].append(logits.numpy())
        for i in range(DECODE_STEPS):
            logits, caches = decode(dec[i], caches)
            out["logits"].append(logits.numpy())
    out["coll"] = coll.snapshot()
    out["caches"] = {f"{key}|{i}": a.numpy() for key, c in caches.blocks.items()
                     for i, a in enumerate(c) if isinstance(a, torch.Tensor)}
    reference = numpy_tree(strip_derived(params))
    out["shapes"] = {p: tuple(a.shape) for p, a in _paths(reference)}
    out["bytes"] = sum(a.nbytes for _, a in _paths(reference))
    out["derived"] = sorted({p.rsplit("/", 1)[1] for p, _ in _paths(
        numpy_tree(params)) if p.rsplit("/", 1)[1] in DERIVED + (RUN,)})
    if case_id == SERVER_CASE:
        from repro_torch.launch.serve import Server

        srv = Server(cfg, SHAPE_ENTRY["seq_len"], mesh=mesh,
                     params=tree_map(torch.from_numpy, full), dtype=torch.float32)
        out["tokens"] = srv.generate(toks.numpy(), SERVER_TOKENS)
    return out


def cases(world) -> dict:
    torch.set_num_threads(1)
    SHAPES[SHAPE] = SHAPE_ENTRY
    return {c[0]: case(world, *c) for c in CASES}
