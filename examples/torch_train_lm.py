"""Train a reduced assigned architecture end to end over the PyTorch +
CUDA port (driver example).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 40 [--sparse-ffn]

Uses the port's TrainLoop: AdamW, checkpointing, fault-tolerant restart;
add --sparse-ffn to run the FFN through the SparseP block kernel
(``bcoo_spmv``, forward and backward).  It runs on the card unless asked
for the CPU (``--device cpu``).
"""
import argparse
from dataclasses import replace

from repro_torch.api.plan import check_device
from repro_torch.configs import get_config
from repro_torch.launch.train import TrainLoop
from repro_torch.optim import AdamWConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--sparse-ffn", action="store_true",
                    help="block-sparse FFN via SparseP kernels (density 0.5)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    cfg = get_config(args.arch).reduced()
    if args.sparse_ffn:
        cfg = replace(cfg, ffn_density=0.5, sparse_block=(8, 16))
    opt = AdamWConfig(lr_peak=2e-3, warmup_steps=args.steps // 4,
                      total_steps=args.steps)
    loop = TrainLoop(cfg, opt, seq_len=64, global_batch=8,
                     ckpt_dir=args.ckpt_dir, device=device)
    loop.init_state()
    losses = loop.run(args.steps)
    print(f"{args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'sparse' if args.sparse_ffn else 'dense'} FFN)")
    return {"sparse_ffn": args.sparse_ffn, "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()
