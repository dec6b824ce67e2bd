"""Training driver: train step + checkpoint/restart on one device.

Counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 50 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The reference jits the step over a mesh; the port has no mesh and runs
the step eagerly on one device (the card unless ``device="cpu"``).

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
from repro_torch.data import TokenStream
from repro_torch.launch import steps as S
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, apply_updates, compress_grads, init_opt,
                               init_residual)
from repro_torch.runtime import (HealthMonitor, RestartPolicy, latest_step,
                                 restore_checkpoint, save_checkpoint)
from repro_torch.sparse.layers import strip_derived, with_derived

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Owns the state and the step function; exposes run(n_steps) with
    restart hooks.

    ``device`` defaults to the card and raises without one.  ``params``
    hold the sparse layers' port-only keys; ``opt`` (and the checkpoints)
    the reference's tree without them.  Each step updates ``params`` and
    ``opt`` in place, as the reference's jitted step donates them.
    """

    def __init__(self, cfg, opt_cfg: AdamWConfig, *, seq_len: int,
                 global_batch: int, ckpt_dir: str | None = None,
                 ckpt_every: int = 50, seed: int = 0,
                 compress_pod_grads: bool = False, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainLoop needs a CUDA device; pass device='cpu' "
                               "to run on the host")
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.stream = TokenStream(cfg.vocab, seq_len, global_batch, seed)
        self.compress = compress_pod_grads
        self.monitor = HealthMonitor(n_hosts=1)
        self.policy = RestartPolicy()
        base_step = S.make_train_step(cfg, opt_cfg, donate=True)
        if compress_pod_grads:
            base_step = self._wrap_compressed(base_step)
        self.step_fn = base_step
        self.params = None
        self.opt = None
        self.residual = None
        self.step = 0

    def _wrap_compressed(self, base_step):
        cfg, opt_cfg = self.cfg, self.opt_cfg
        vag = S.value_and_grad_trainable(lm.loss_fn)

        def step_with_ef(params, opt, batch, residual):
            loss, grads = vag(params, batch, cfg)
            grads, residual = compress_grads(strip_derived(grads), residual)
            new, opt, metrics = apply_updates(strip_derived(params), grads, opt,
                                              opt_cfg, donate=True)
            metrics["loss"] = loss
            return S.carry_derived(new, params), opt, metrics, residual

        return step_with_ef

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0):
        """Seeded params (bf16, as the reference's ``init_params``) and zero
        optimizer state on the loop's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            self.params = lm.init_params(gen, self.cfg)
        self.opt = init_opt(strip_derived(self.params), self.opt_cfg)
        if self.compress:
            self.residual = init_residual(strip_derived(self.params))
        self.step = 0

    def maybe_restore(self) -> bool:
        """Restore the latest complete checkpoint, if any (a fresh init is
        the template when the loop has no state yet)."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return False
        if self.params is None:
            self.init_state()
        like = (strip_derived(self.params), self.opt)
        (params, self.opt), self.step = restore_checkpoint(
            self.ckpt_dir, like, device=self.device)
        self.params = with_derived(params, self.cfg)
        if self.compress:
            self.residual = init_residual(params)
        return True

    def save(self):
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.step,
                            (strip_derived(self.params), self.opt))

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
                # one device has no smaller mesh to rescale to: a step that
                # keeps failing past the policy's retries is raised
                if not self.ckpt_dir or action == "rescale":
                    raise
                print(f"[fault] step {self.step}: {e} -> {action}")
                self.maybe_restore()
                continue
            self.step += 1
            dt = time.monotonic() - t0
            self.monitor.beat(0, self.step, dt)
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
    loop = TrainLoop(cfg, opt_cfg, seq_len=args.seq, global_batch=args.batch,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     compress_pod_grads=args.compress_pod_grads,
                     device=args.device)
    loop.init_state()
    if args.resume:
        loop.maybe_restore()
    losses = loop.run(args.steps)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
