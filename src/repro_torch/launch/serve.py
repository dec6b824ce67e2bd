"""Serving launcher: batched prefill + greedy decode with a static batch.

Counterpart of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --batch 4 --prompt-len 32 --gen 16 [--reduced] [--device cpu]

Started as the ranks of a world by ``torchrun`` (``torchrun --nproc-per-node
4 -m repro_torch.launch.serve``), ``main`` serves on
``launch.mesh.make_local_mesh(world=)``, the data-parallel mesh of the
ranks, as the reference's ``main`` on its host's devices; otherwise on one
device.

``--arch`` takes the dense family, the MoE family (mixtral-8x22b,
deepseek-v3-671b), the hybrid zamba2-2.7b (Mamba2 blocks and a shared
attention + MLP block) and the recurrent xlstm-1.3b (mLSTM and sLSTM
blocks, whose caches are O(1) states).  The encoder-decoder
seamless-m4t-medium needs encoder frames, which ``Server`` (like the
reference's) does not take: it raises ``ValueError`` naming
``launch.steps.make_prefill_step`` / ``make_decode_step``, which serve it.

The reference jits ``lm.prefill`` and ``lm.decode_step`` over a mesh
with its params placed by ``lm.param_specs``.  The port runs them eagerly:
on one device (the card unless ``--device cpu``), or, given ``mesh=`` (a
``core.mesh.ProcessMesh`` over a world of ranks, e.g.
``launch.mesh.make_local_mesh(mp, world=world)``), on every rank of it,
each holding only its blocks of the params (``convert.shard_params``) and
running the sharded program (``models/lm.py``); every rank's ``generate``
returns the same (B, n) tokens.  Every arch but the encoder-decoder is
served there: the attention and MoE families, zamba2's Mamba2 blocks and
shared block, xlstm's mLSTM and sLSTM blocks (each rank its heads).  The
encoder-decoder raises the same ``ValueError`` on a mesh as on one device;
the step builders serve it on a mesh too.  Params come from a seeded init
(the generator seeded with 0, as the reference's ``PRNGKey(0)``) or from
the caller (``params=``, the reference's tree of full leaves).  Ranks that
share one card build their blocks in turn, so one full tree at a time lies
on it.
With ``cfg.ffn_density < 1`` every FFN projection runs on the block kernel
(zamba2's: the shared block's three, once per invocation; on a mesh each
rank's run of the stream).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.core.world import close_world
from repro_torch.launch.mesh import env_world, make_local_mesh
from repro_torch.models import lm
from repro_torch.sparse.layers import strip_derived, with_derived
from repro_torch.tree import tree_map

__all__ = ["Server", "mesh_params", "main"]


def mesh_params(cfg, mesh, dtype=torch.bfloat16, params=None):
    """This rank's blocks of the params on ``mesh`` (``params``, the
    reference's tree of full leaves, or the seeded init), with the
    port-only keys of its runs of the block streams (collective: every
    rank of the mesh calls it)."""
    from repro_torch.analysis.sharded import abstract_params as reference_tree
    from repro_torch.convert import param_shardings
    from repro_torch.runtime.elastic import seeded_blocks, shard_tree

    if params is not None:
        params = strip_derived(params)
        local = shard_tree(params, param_shardings(cfg, mesh, params), mesh.device)
        return with_derived(local, cfg, mesh)
    like = reference_tree(cfg, dtype)
    local = seeded_blocks(cfg, like, param_shardings(cfg, mesh, like), mesh, 0, dtype)
    return with_derived(local, cfg, mesh)


class Server:
    """Greedy generation for one config on one device or a process mesh.

    ``device`` defaults to the card and raises without one (on a mesh the
    rank's device); ``dtype`` is the params' (bfloat16, as the reference's
    ``init_params``); ``params`` the reference's tree of full leaves
    (default: the seeded init).
    """

    def __init__(self, cfg, max_len: int, *, mesh=None, device=None,
                 dtype=torch.bfloat16, params=None):
        self.mesh = mesh
        if cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: Server passes no encoder "
                f"memory; serve it with launch.steps.make_prefill_step (which "
                f"encodes batch['frames']) and make_decode_step (batch['memory'])")
        if mesh is not None:
            self.cfg, self.max_len, self.device = cfg, max_len, mesh.device
            with torch.no_grad():
                self.params = mesh_params(cfg, mesh, dtype, params)
            return
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server needs a CUDA device; pass device='cpu' "
                               "to run on the host")
        self.cfg, self.max_len = cfg, max_len
        with torch.no_grad():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(0)
                self.params = lm.init_params(gen, cfg, dtype)
            else:
                self.params = with_derived(tree_map(lambda t: t.to(self.device),
                                                    strip_derived(params)), cfg)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 timings: dict | None = None) -> np.ndarray:
        """prompts: (B, S) int32. Greedy decode n_tokens. Returns
        (B, max(n_tokens, 1)), as the reference: the prefill's token always,
        then n_tokens - 1 decode steps.  On a mesh every rank gets the whole
        (B, n): each step's tokens are gathered over the batch axes.

        The tokens stay on the device until the end, then cross to the
        host in one copy.  ``timings``, where given, gets the host seconds
        of the prefill (``prefill_s``, to its token on the device) and of
        the decode steps after it (``decode_s``)."""
        toks = torch.from_numpy(np.asarray(prompts, np.int32)).to(self.device)
        B = toks.shape[0]
        out = torch.empty((B, max(n_tokens, 1)), dtype=torch.int32,
                          device=self.device)

        def pick(logits):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            if self.mesh is None:
                return tok
            with SH.batch_scope(B):
                return SH.batch_unshard(tok)

        def clock():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        with torch.no_grad(), SH.set_mesh(self.mesh):
            t0 = clock() if timings is not None else 0.0
            logits, caches = lm.prefill(self.params, toks, self.cfg, self.max_len)
            tok = pick(logits)
            out[:, :1] = tok
            t1 = clock() if timings is not None else 0.0
            for i in range(1, n_tokens):
                logits, caches = lm.decode_step(self.params, tok, caches, self.cfg)
                tok = pick(logits)
                out[:, i:i + 1] = tok
            if timings is not None:
                timings.update(prefill_s=t1 - t0, decode_s=clock() - t1)
        return out.cpu().numpy()



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = env_world(args.device)
    try:
        max_len = args.prompt_len + args.gen
        if world is None:
            server, where = Server(cfg, max_len=max_len, device=args.device), ""
        else:
            mesh = make_local_mesh(world=world)
            server = Server(cfg, max_len=max_len, mesh=mesh)
            where = f" rank {world.rank} of mesh {tuple(mesh.devices.shape)}"
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                               ).astype(np.int32)
        t0 = time.monotonic()
        out = server.generate(prompts, args.gen)
        dt = time.monotonic() - t0
        print(f"generated {out.shape} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s) on {server.device}{where}")
        print(out[:2, :12])
        return out
    finally:
        if world is not None:
            close_world()


if __name__ == "__main__":
    main()
