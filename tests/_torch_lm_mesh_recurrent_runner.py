"""Subprocess body of tests/test_torch_lm_mesh_recurrent.py: the JAX side.

It needs 4 fake devices, so it owns its process (XLA_FLAGS is set before
jax imports).  For every case of tests/_torch_lm_mesh_recurrent_cases.py
it places the filled params on the case's mesh as ``lm.param_specs`` say
(``make_shardings`` + ``sanitize_shardings``) and, jitted under
``compat.set_mesh``, runs ``lm.prefill`` and 3 ``lm.decode_step``s, or
for the encoder-decoder ``launch.steps.make_prefill_step`` (which encodes
the frames) and ``make_decode_step`` with the memory of ``lm.encode``.
It stores the logits, the final caches of every block, each leaf's local
shard shape, and for the Server case the greedy tokens.  Prints ``DEVICES
<n>`` first and ``LM MESH SKIP`` when forcing devices failed.

    python tests/_torch_lm_mesh_recurrent_runner.py OUT.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.launch import steps  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.runtime.elastic import make_shardings, sanitize_shardings  # noqa: E402

from _torch_lm_mesh_recurrent_cases import (CASES, DECODE_STEPS,  # noqa: E402
                                            SERVER_CASE, SERVER_TOKENS, SHAPE,
                                            SHAPE_ENTRY, _paths, config, fill,
                                            frames, lm_inputs)


def shard_shapes(tree, sh) -> dict:
    leaves = dict(_paths(tree))
    shards = dict(_paths(jax.tree.map(lambda s: s, sh,
                                      is_leaf=lambda x: hasattr(x, "spec"))))
    return {p: np.asarray(shards[p].shard_shape(leaves[p].shape)) for p in leaves}


def store_caches(res, case_id, caches) -> None:
    for key, c in caches.blocks.items():
        for i, a in enumerate(c):
            if np.ndim(a) > 1:  # a KV cache's length is not stored
                res[f"{case_id}|cache|{key}|{i}"] = np.asarray(a)


def case(res, case_id, arch, shape, overrides) -> None:
    cfg = config(get_config, arch, overrides)
    mesh = compat.make_mesh(shape, ("data", "model"))
    tree = fill(jax.tree.map(np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg,
                                                        jnp.float32)), 0)
    sh = sanitize_shardings(make_shardings(mesh, lm.param_specs(cfg)), tree)
    params = jax.device_put(tree, sh)
    for path, s in shard_shapes(tree, sh).items():
        res[f"{case_id}|shard|{path}"] = s
    toks, dec = lm_inputs(cfg)
    with compat.set_mesh(mesh):
        if cfg.encoder_layers:
            fr = frames(cfg)
            pre = jax.jit(steps.make_prefill_step(cfg, SHAPE))
            step = jax.jit(steps.make_decode_step(cfg, SHAPE))
            memory = jax.jit(lambda p, f: lm.encode(p, f, cfg))(params, fr)
            logits, caches = pre(params, {"tokens": toks, "frames": fr})

            def decode(p, t, c):
                return step(p, {"token": t, "caches": c, "memory": memory})
        else:
            prefill = jax.jit(lambda p, t: lm.prefill(p, t, cfg, SHAPE_ENTRY["seq_len"]))
            decode = jax.jit(lambda p, t, c: lm.decode_step(p, t, c, cfg))
            logits, caches = prefill(params, toks)
        res[f"{case_id}|prefill"] = np.asarray(logits)
        for i in range(DECODE_STEPS):
            logits, caches = decode(params, dec[i], caches)
            res[f"{case_id}|decode{i}"] = np.asarray(logits)
        store_caches(res, case_id, caches)
        if case_id == SERVER_CASE:  # Server.generate's greedy loop
            logits, caches = prefill(params, toks)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out = [tok]
            for _ in range(SERVER_TOKENS - 1):
                logits, caches = decode(params, tok, caches)
                tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                out.append(tok)
            res[f"{case_id}|tokens"] = np.concatenate([np.asarray(t) for t in out], 1)


def main(out_path: str) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < 4:
        print("LM MESH SKIP")
        return
    SHAPES[SHAPE] = SHAPE_ENTRY
    res = {}
    for c in CASES:
        case(res, *c)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
