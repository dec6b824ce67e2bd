"""Subprocess body of tests/test_torch_lm_mesh_train_recurrent.py: the JAX
package's side, on 4 fake CPU devices (XLA_FLAGS is set before jax
imports).

For every case of tests/_torch_lm_mesh_train_recurrent_cases.py it places
the filled f32 params on the case's mesh (``make_shardings`` +
``sanitize_shardings`` of ``lm.param_specs``) and, under
``compat.set_mesh``, stores the loss and every gradient leaf of
``_value_and_grad_trainable(lm.loss_fn)`` and the params after one jitted
``make_train_step`` (the enc-dec arch's batch carries its frames; for the
int8 case also its second moments).  Then JAX's ``TrainLoop`` on the
zamba2 (2, 2) mesh from the same params: its losses, writing a checkpoint
every CKPT_EVERY steps under ``OUT_DIR/jax_ckpt``.  Prints ``DEVICES <n>``
first and ``LM MESH SKIP`` when forcing devices failed.

    python tests/_torch_lm_mesh_train_recurrent_runner.py OUT.npz OUT_DIR [PART]

PART (default: everything) is a comma-separated list of case ids and
``loop``, so that two processes share the work.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.train import TrainLoop  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.optim import AdamWConfig, init_opt  # noqa: E402
from repro.runtime.elastic import make_shardings, sanitize_shardings  # noqa: E402

from _torch_lm_mesh_cases import config  # noqa: E402
from _torch_lm_mesh_train_recurrent_cases import (B, CASES, CKPT_EVERY,  # noqa: E402
                                                  LOOP_ARCH, LOOP_MESH, LOOP_SEQ,
                                                  LOOP_STEPS, OPT, QUANT_CASE, batch)
from _torch_lm_mesh_train_runner import filled, store  # noqa: E402


def train_case(res, case_id, arch, shape, overrides, mb):
    cfg = config(get_config, arch, overrides)
    mesh = compat.make_mesh(shape, ("data", "model"))
    tree = filled(cfg)
    sh = sanitize_shardings(make_shardings(mesh, lm.param_specs(cfg)), tree)
    params = jax.device_put(tree, sh)
    b = batch(cfg)
    opt_cfg = AdamWConfig(**OPT)
    with compat.set_mesh(mesh):
        vag = jax.jit(lambda p, x: JS._value_and_grad_trainable(lm.loss_fn)(p, x, cfg))
        loss, grads = vag(params, b)
        res[f"{case_id}|loss"] = np.asarray(loss)
        store(res, f"{case_id}|grads", grads)
        opt = jax.jit(lambda p: init_opt(p, opt_cfg))(params)
        new, _, metrics = jax.jit(JS.make_train_step(cfg, opt_cfg, mb))(params, opt, b)
        res[f"{case_id}|step_loss"] = np.asarray(metrics["loss"])
        store(res, f"{case_id}|params", new)
        if case_id == QUANT_CASE:
            q_cfg = AdamWConfig(**OPT, quantized_v=True)
            opt = jax.jit(lambda p: init_opt(p, q_cfg))(params)
            new, opt, _ = jax.jit(JS.make_train_step(cfg, q_cfg))(params, opt, b)
            store(res, f"{case_id}|quant_params", new)
            store(res, f"{case_id}|quant_v", opt.v)


def train_loop(res, out_dir):
    cfg = config(get_config, LOOP_ARCH, {})
    mesh = compat.make_mesh(LOOP_MESH, ("data", "model"))
    loop = TrainLoop(cfg, AdamWConfig(**OPT), mesh, seq_len=LOOP_SEQ, global_batch=B,
                     ckpt_dir=os.path.join(out_dir, "jax_ckpt"),
                     ckpt_every=CKPT_EVERY)
    loop.init_state()
    loop.params = jax.device_put(filled(cfg), loop.p_sh)
    with compat.set_mesh(mesh):
        loop.opt = jax.jit(lambda p: init_opt(p, loop.opt_cfg),
                           out_shardings=loop.o_sh)(loop.params)
    res["loop|losses"] = np.asarray(loop.run(LOOP_STEPS, log_every=0))


def main(out_path: str, out_dir: str, part: str | None = None) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < 4:
        print("LM MESH SKIP")
        return
    names = None if part is None else set(part.split(","))
    res = {}
    for case in CASES:
        if names is None or case[0] in names:
            train_case(res, *case)
    if names is None or "loop" in names:
        train_loop(res, out_dir)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(*sys.argv[1:4])
