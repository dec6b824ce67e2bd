"""Deterministic synthetic LM token pipeline.

Counterpart of ``repro/data/tokens.py``, array for array: the numpy core
is the reference's, and the batch crosses to torch as int32 tensors on
the device the caller names.

Production properties the trainer relies on:
  * **step-addressable**: batch(step) is a pure function of (seed, step), so
    a restarted job resumes mid-epoch with zero duplication/skip — the data
    side of fault tolerance (tested in tests/test_torch_train_loop.py).
  * structured enough to have learnable signal (Zipf unigrams + planted
    bigrams) so the train-loop convergence test is meaningful.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TokenStream", "make_batch"]


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, device=None) -> dict:
        return make_batch(self.vocab, self.seq_len, self.global_batch,
                          self.seed, step, device)


def make_batch(vocab: int, seq_len: int, global_batch: int, seed: int,
               step: int, device=None) -> dict:
    """Zipf tokens with planted bigram structure; labels = next-token copy.

    ``tokens`` and ``labels`` are the same (global_batch, seq_len) int32
    tensor, on ``device`` (default: the CPU)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    toks = rng.choice(vocab, size=(global_batch, seq_len), p=p).astype(np.int32)
    # plant deterministic bigrams: token t at even positions forces (t+1)%V
    even = toks[:, 0::2]
    toks[:, 1::2] = (even[:, : toks[:, 1::2].shape[1]] + 1) % vocab
    t = torch.from_numpy(toks).to(device)
    return {"tokens": t, "labels": t}
