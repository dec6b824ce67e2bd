"""Subprocess body of tests/test_torch_lm_mesh.py: the JAX package's side.

It needs 4 fake devices, so it owns its process (XLA_FLAGS is set before
jax imports).  For every case of tests/_torch_lm_mesh_cases.py it places
the params on the case's mesh as ``lm.param_specs`` say
(``make_shardings`` + ``sanitize_shardings``) and runs ``lm.prefill`` and
the decode steps jitted under ``compat.set_mesh``; it stores the logits
(the global batch), each leaf's local shard shape, and for the Server case
the greedy tokens.  For the MoE cases it runs ``moe_apply`` on the mesh
and stores y and each dispatch group's kept assignments (``_route_*`` and
``_local_dispatch`` of the group's tokens, as the reference's vmap over
groups computes them), and the one-group counts for comparison.  Prints
``DEVICES <n>`` first and ``LM MESH SKIP`` when forcing devices failed.

    python tests/_torch_lm_mesh_runner.py OUT.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.runtime.elastic import make_shardings, sanitize_shardings  # noqa: E402

from _torch_lm_mesh_cases import (DECODE_STEPS, LM_CASES, MAX_LEN,  # noqa: E402
                                  MOE_CASES, MOE_MESH, SERVER_CASE,
                                  SERVER_TOKENS, _paths, config, fill, lm_inputs,
                                  moe_input)


def place(tree, specs, mesh):
    sh = sanitize_shardings(make_shardings(mesh, specs), tree)
    return jax.device_put(tree, sh), sh


def shard_shapes(tree, sh) -> dict:
    leaves = dict(_paths(tree))
    shards = dict(_paths(jax.tree.map(lambda s: s, sh,
                                      is_leaf=lambda x: hasattr(x, "spec"))))
    return {p: np.asarray(shards[p].shard_shape(leaves[p].shape))
            for p in leaves}


def lm_case(res, case_id, arch, shape, overrides):
    cfg = config(get_config, arch, overrides)
    mesh = compat.make_mesh(shape, ("data", "model"))
    tree = fill(jax.tree.map(np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg,
                                                        jnp.float32)), 0)
    params, sh = place(tree, lm.param_specs(cfg), mesh)
    for path, s in shard_shapes(tree, sh).items():
        res[f"{case_id}|shard|{path}"] = s
    toks, steps = lm_inputs(cfg)
    with compat.set_mesh(mesh):
        prefill = jax.jit(lambda p, t: lm.prefill(p, t, cfg, MAX_LEN))
        decode = jax.jit(lambda p, t, c: lm.decode_step(p, t, c, cfg))
        logits, caches = prefill(params, toks)
        res[f"{case_id}|prefill"] = np.asarray(logits)
        for i in range(DECODE_STEPS):
            logits, caches = decode(params, steps[i], caches)
            res[f"{case_id}|decode{i}"] = np.asarray(logits)
        if case_id == SERVER_CASE:  # Server.generate's greedy loop
            logits, caches = prefill(params, toks)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out = [tok]
            for _ in range(SERVER_TOKENS - 1):
                logits, caches = decode(params, tok, caches)
                tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                out.append(tok)
            res[f"{case_id}|tokens"] = np.concatenate([np.asarray(t) for t in out], 1)


def kept(p, x, cfg, G: int) -> list:
    """Kept assignments of each of G dispatch groups of x's tokens."""
    Bx, Sx, d = x.shape
    T_loc = Bx * Sx // G
    cap = cfg.moe_capacity(T_loc)
    out = []
    for g in range(G):
        xg = jnp.asarray(x.reshape(G, T_loc, d)[g])
        route = (M._route_deepseek(p, xg, cfg.moe_top_k)
                 if cfg.moe_router == "deepseek"
                 else M._route_mixtral(p, xg, cfg.moe_top_k))
        eid = route.expert.reshape(-1)
        gate = route.weight.reshape(-1)
        _, meta = M._local_dispatch(xg, eid, gate, cfg.n_experts, cap)
        out.append(int(np.asarray(meta[3]).sum()))
    return out


def moe_case(res, case_id, arch, overrides):
    cfg = config(get_config, arch, overrides)
    mesh = compat.make_mesh(MOE_MESH, ("data", "model"))
    tree = fill(jax.tree.map(np.asarray, M.moe_init(jax.random.PRNGKey(1), cfg,
                                                    jnp.float32)), 1)
    params, _ = place(tree, M.moe_spec(cfg), mesh)
    x = moe_input(cfg)
    with compat.set_mesh(mesh):
        y = jax.jit(lambda p, v: M.moe_apply(p, v, cfg))(params, x)
    res[f"{case_id}|y"] = np.asarray(y)
    res[f"{case_id}|kept"] = np.asarray(kept(tree, x, cfg, MOE_MESH[0]))
    res[f"{case_id}|kept_one_group"] = np.asarray(kept(tree, x, cfg, 1))


def main(out_path: str) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < 4:
        print("LM MESH SKIP")
        return
    res = {}
    for case_id, arch, shape, overrides in LM_CASES:
        lm_case(res, case_id, arch, shape, overrides)
    for case_id, arch, overrides in MOE_CASES:
        moe_case(res, case_id, arch, overrides)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
