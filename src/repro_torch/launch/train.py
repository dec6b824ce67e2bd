"""Training driver: train step + checkpoint/restart on one device.

Counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 50 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The reference jits the step over a mesh.  The port runs the step eagerly
on one device (the card unless ``device="cpu"``), or, given ``mesh=`` (a
``core.mesh.ProcessMesh``), on every rank of it: each rank holds its blocks
of the params and the optimizer state (``launch.steps.state_specs``
through ``make_shardings`` + ``sanitize_shardings``, as the reference's
``TrainLoop``), builds the whole ``TokenStream`` batch, runs the sharded
step (``launch.steps.make_train_step`` under ``set_mesh``) on its rows, and
checkpoints the full leaves collectively; a restore takes its blocks, on
this mesh or on a smaller one (``runtime.elastic.rescaled_mesh``).  Every
arch trains there that trains on one device: the attention and MoE
families, zamba2 and xlstm (the encoder-decoder's batches carry frames,
which ``TokenStream`` does not make, on a mesh as on one device:
``launch.steps.make_train_step`` trains it).  ``main``
runs on ``launch.mesh.make_local_mesh(world=)``, the data-parallel mesh of
the ranks, where ``torchrun`` started it as the ranks of a world
(``torchrun --nproc-per-node 4 -m repro_torch.launch.train``), as the
reference's ``main`` on its host's devices, and on one device otherwise.

    world = repro_torch.core.world.init_world("gloo", rank, 4, store_path)
    mesh = repro_torch.core.mesh.make_process_mesh(world, (2, 2),
                                                   ("data", "model"))
    loop = TrainLoop(cfg, AdamWConfig(), mesh=mesh, seq_len=256,
                     global_batch=4, ckpt_dir="ckpt", ckpt_every=5)
    loop.init_state()
    losses = loop.run(10)            # every rank: the global batch's losses

Fault-tolerance loop: every step is checkpoint-addressable; on failure the
driver restores the latest complete checkpoint and replays from there.
The data pipeline is step-addressable so the replay is exact
(data/tokens.py).  Checkpoints are the reference's format, so either
package resumes the other's run.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.core.world import close_world
from repro_torch.data import TokenStream
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import env_world, make_local_mesh
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, apply_updates, compress_grads, init_opt,
                               init_residual)
from repro_torch.runtime import (HealthMonitor, RestartPolicy, latest_step,
                                 restore_checkpoint, save_checkpoint)
from repro_torch.sparse.layers import strip_derived, with_derived
from repro_torch.tree import tree_map

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Owns the state and the step function; exposes run(n_steps) with
    restart hooks.

    ``device`` defaults to the card and raises without one; with ``mesh``
    it is the rank's.  ``params`` hold the sparse layers' port-only keys;
    ``opt`` (and the checkpoints) the reference's tree without them.  Each
    step updates ``params`` and ``opt`` in place, as the reference's jitted
    step donates them.  On a mesh every rank calls every method together.
    """

    def __init__(self, cfg, opt_cfg: AdamWConfig, *, seq_len: int,
                 global_batch: int, ckpt_dir: str | None = None,
                 ckpt_every: int = 50, seed: int = 0,
                 compress_pod_grads: bool = False, device=None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device
        else:
            self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainLoop needs a CUDA device; pass device='cpu' "
                               "to run on the host")
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.stream = TokenStream(cfg.vocab, seq_len, global_batch, seed)
        self.compress = compress_pod_grads
        self.monitor = HealthMonitor(n_hosts=1 if mesh is None else mesh.devices.size)
        self.policy = RestartPolicy()
        self.p_sh = self.o_sh = None
        if mesh is not None:
            self._shardings()
        base_step = S.make_train_step(cfg, opt_cfg, donate=True)
        if compress_pod_grads:
            base_step = self._wrap_compressed(base_step)
        self.step_fn = base_step
        self.params = None
        self.opt = None
        self.residual = None
        self.step = 0

    def _shardings(self):
        """The params' and the optimizer state's sanitized NamedSharding
        trees on the mesh, against the abstract state (the reference's
        ``:52-66``): a spec entry whose extent does not divide its dim is
        dropped."""
        from repro_torch.analysis.sharded import abstract_params
        from repro_torch.runtime.elastic import make_shardings, sanitize_shardings

        _, ospecs = S.state_specs(self.cfg, self.opt_cfg)
        self._like = abstract_params(self.cfg)
        with self._like["embed"]["emb"].fake_mode:
            opt_like = init_opt(self._like, self.opt_cfg)
        self.p_sh = S.mesh_param_shardings(self.cfg, self.mesh)
        self.o_sh = sanitize_shardings(make_shardings(self.mesh, ospecs), opt_like)

    def _wrap_compressed(self, base_step):
        cfg, opt_cfg = self.cfg, self.opt_cfg

        def step_with_ef(params, opt, batch, residual):
            mesh = SH.get_abstract_mesh()
            sh = None if mesh is None else S.mesh_param_shardings(cfg, mesh)
            loss, grads = S.loss_and_grads(params, batch, cfg)
            grads, residual = compress_grads(grads, residual, mesh)
            new, opt, metrics = apply_updates(strip_derived(params), grads, opt,
                                              opt_cfg, donate=True, shardings=sh)
            metrics["loss"] = loss
            return S.carry_derived(new, params), opt, metrics, residual

        return step_with_ef

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0, params=None):
        """Seeded params (bf16, as the reference's ``init_params``), or
        ``params`` (the reference's tree of full leaves), and zero optimizer
        state on the loop's device; on a mesh, the rank's blocks."""
        with torch.no_grad():
            if self.mesh is not None:
                self.params = self._rank_params(seed, params)
            elif params is not None:
                self.params = with_derived(tree_map(lambda t: t.to(self.device),
                                                    strip_derived(params)), self.cfg)
            else:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.params = lm.init_params(gen, self.cfg)
        self.opt = init_opt(strip_derived(self.params), self.opt_cfg)
        if self.compress:
            self.residual = init_residual(strip_derived(self.params))
        self.step = 0

    def _rank_params(self, seed: int, params):
        """This rank's blocks of the params (``runtime.elastic.
        seeded_blocks`` for the seeded init), with the port-only keys."""
        from repro_torch.runtime.elastic import seeded_blocks, shard_tree

        if params is not None:
            local = shard_tree(strip_derived(params), self.p_sh, self.device)
        else:
            local = seeded_blocks(self.cfg, self._like, self.p_sh, self.mesh, seed)
        return with_derived(local, self.cfg, self.mesh)

    def maybe_restore(self) -> bool:
        """Restore the latest complete checkpoint, if any (a fresh init is
        the template when the loop has no state yet); on a mesh, this
        rank's blocks of it, whatever mesh wrote it."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return False
        if self.params is None and self.mesh is not None:
            from repro_torch.runtime.elastic import empty_blocks

            # the template's shapes: the rank's blocks, nothing drawn
            blocks = empty_blocks(self._like, self.p_sh, self.device)
            like = (blocks, init_opt(blocks, self.opt_cfg))
        else:
            if self.params is None:
                self.init_state()
            like = (strip_derived(self.params), self.opt)
        shardings = None if self.mesh is None else (self.p_sh, self.o_sh)
        (params, self.opt), self.step = restore_checkpoint(
            self.ckpt_dir, like, device=self.device, shardings=shardings)
        self.params = with_derived(params, self.cfg, self.mesh)
        if self.compress:
            self.residual = init_residual(params)
        return True

    def save(self):
        """Checkpoint the state at the current step (collective on a
        mesh: the ranks write the full leaves in turn, rank 0 publishes)."""
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.step,
                            (strip_derived(self.params), self.opt),
                            shardings=None if self.mesh is None
                            else (self.p_sh, self.o_sh))

    # -- loop ----------------------------------------------------------------

    def run(self, n_steps: int, log_every: int = 10, fail_at=None):
        """Train n_steps; ``fail_at`` (a set of steps) injects failures."""
        losses = []
        while self.step < n_steps:
            t0 = time.monotonic()
            batch = self.stream.batch(self.step, self.device)
            try:
                if fail_at is not None and self.step in fail_at:
                    fail_at.remove(self.step)
                    raise RuntimeError(f"injected failure at step {self.step}")
                with SH.set_mesh(self.mesh):
                    if self.compress:
                        self.params, self.opt, metrics, self.residual = self.step_fn(
                            self.params, self.opt, batch, self.residual
                        )
                    else:
                        self.params, self.opt, metrics = self.step_fn(
                            self.params, self.opt, batch
                        )
            except RuntimeError as e:
                action = self.policy.on_failure(self.step)
                # the loop has no smaller mesh to rescale to in place (a
                # smaller mesh restores the checkpoint: runtime.elastic):
                # a step that keeps failing past the retries is raised
                if not self.ckpt_dir or action == "rescale":
                    raise
                print(f"[fault] step {self.step}: {e} -> {action}")
                self.maybe_restore()
                continue
            self.step += 1
            dt = time.monotonic() - t0
            self.monitor.beat(0 if self.mesh is None else self.mesh.rank,
                              self.step, dt)
            loss = float(metrics["loss"])
            losses.append(loss)
            if log_every and self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if self.ckpt_dir and self.step % self.ckpt_every == 0:
                self.save()
        return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to CPU-smoke size")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=min(20, args.steps // 3),
                          total_steps=args.steps)
    world = env_world(args.device)
    try:
        where = {"device": args.device} if world is None else {
            "mesh": make_local_mesh(world=world)}
        loop = TrainLoop(cfg, opt_cfg, seq_len=args.seq, global_batch=args.batch,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         compress_pod_grads=args.compress_pod_grads, **where)
        loop.init_state()
        if args.resume:
            loop.maybe_restore()
        losses = loop.run(args.steps)
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
        return losses
    finally:
        if world is not None:
            close_world()


if __name__ == "__main__":
    main()
