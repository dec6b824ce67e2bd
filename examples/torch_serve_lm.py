"""Serve a reduced assigned architecture with batched requests, over the
PyTorch + CUDA port.

It runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen1.5-0.5b [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.api.plan import check_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import Server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    cfg = get_config(args.arch).reduced()
    server = Server(cfg, max_len=args.prompt_len + args.gen, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                           ).astype(np.int32)
    t0 = time.monotonic()
    out = server.generate(prompts, args.gen)
    dt = time.monotonic() - t0
    print(f"{args.arch}: {out.shape[0]} requests x {out.shape[1]} tokens "
          f"in {dt:.2f}s ({out.size / dt:.1f} tok/s)")
    print("first request tokens:", out[0].tolist())
    return {"tokens": out, "seconds": dt}


if __name__ == "__main__":
    main()
