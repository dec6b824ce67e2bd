"""Serving launcher: batched prefill + greedy decode with a static batch.

Counterpart of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --batch 4 --prompt-len 32 --gen 16 [--reduced] [--device cpu]

``--arch`` takes the dense family, the MoE family (mixtral-8x22b,
deepseek-v3-671b), the hybrid zamba2-2.7b (Mamba2 blocks and a shared
attention + MLP block) and the recurrent xlstm-1.3b (mLSTM and sLSTM
blocks, whose caches are O(1) states).  The encoder-decoder
seamless-m4t-medium needs encoder frames, which ``Server`` (like the
reference's) does not take: it raises ``ValueError`` naming
``launch.steps.make_prefill_step`` / ``make_decode_step``, which serve it.

The reference jits ``lm.prefill`` and ``lm.decode_step`` over a mesh; the
port has no mesh and runs them eagerly on one device (the card unless
``--device cpu``).  Params come from a seeded init (the generator seeded
with 0, as the reference's ``PRNGKey(0)``); configs are shapes only.  With
``cfg.ffn_density < 1`` every FFN projection runs on the block kernel
(zamba2's: the shared block's three, once per invocation).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm

__all__ = ["Server", "main"]


class Server:
    """Greedy generation for one config on one device.

    ``device`` defaults to the card and raises without one; ``dtype`` is
    the params' (bfloat16, as the reference's ``init_params``).
    """

    def __init__(self, cfg, max_len: int, *, device=None, dtype=torch.bfloat16):
        if cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: Server passes no encoder "
                f"memory; serve it with launch.steps.make_prefill_step (which "
                f"encodes batch['frames']) and make_decode_step (batch['memory'])")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server needs a CUDA device; pass device='cpu' "
                               "to run on the host")
        self.cfg, self.max_len = cfg, max_len
        gen = torch.Generator(device=self.device).manual_seed(0)
        with torch.no_grad():
            self.params = lm.init_params(gen, cfg, dtype)

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """prompts: (B, S) int32. Greedy decode n_tokens. Returns
        (B, max(n_tokens, 1)), as the reference: the prefill's token always,
        then n_tokens - 1 decode steps.

        The tokens stay on the device until the end, then cross to the
        host in one copy."""
        toks = torch.from_numpy(np.asarray(prompts, np.int32)).to(self.device)
        out = torch.empty((toks.shape[0], max(n_tokens, 1)), dtype=torch.int32,
                          device=self.device)
        with torch.no_grad():
            logits, caches = lm.prefill(self.params, toks, self.cfg, self.max_len)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out[:, :1] = tok
            for i in range(1, n_tokens):
                logits, caches = lm.decode_step(self.params, tok, caches, self.cfg)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                out[:, i:i + 1] = tok
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
    server = Server(cfg, max_len=args.prompt_len + args.gen, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.monotonic()
    out = server.generate(prompts, args.gen)
    dt = time.monotonic() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {server.device}")
    print(out[:2, :12])
    return out


if __name__ == "__main__":
    main()
