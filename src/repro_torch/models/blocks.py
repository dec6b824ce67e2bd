"""Layer blocks: one (init, apply, decode, cache) bundle per block kind.

Counterpart of ``repro/models/blocks.py`` for the attention kinds:

  attn          pre-LN GQA + SwiGLU MLP (llama / qwen / smollm / llava)
  attn_local    gemma2 sliding-window layer (+ post-norms, softcaps)
  attn_global   gemma2 full-attention layer

Every other kind of the reference raises ``NotImplementedError`` naming
the ROADMAP.md item that ports it (:data:`UNPORTED`).

The SparseP integration point: when cfg.ffn_density < 1, the MLP is
sparse/layers.py's BlockSparseFFN, whose three projections run on the
block kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import attention as A
from .common import gelu, rmsnorm, rmsnorm_init, swiglu_apply, swiglu_init

__all__ = ["block_init", "block_apply", "block_decode", "init_cache",
           "check_kind", "KINDS", "UNPORTED"]

KINDS = ("attn", "attn_local", "attn_global")
# block kind -> the ROADMAP.md item that ports it
UNPORTED = {
    "moe": "§1 item 2 (MoE)",
    "mla_dense": "§1 item 3 (MLA)",
    "mla_moe": "§1 item 3 (MLA)",
    "mamba": "§1 item 4 (linear attention)",
    "mlstm": "§1 item 4 (linear attention)",
    "slstm": "§1 item 4 (linear attention)",
    "shared_attn": "§1 item 4 (linear attention: zamba2's shared block)",
    "cross_attn": "§1 item 5 (encoder-decoder)",
}


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not run."""
    if kind in KINDS:
        return
    if kind in UNPORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md {UNPORTED[kind]})")
    raise ValueError(f"unknown block kind {kind!r}")


def _window(cfg, kind):
    if kind == "attn_global":
        return None
    return cfg.sliding_window  # attn_local / plain attn configs


def _mlp_init(gen, cfg, dtype):
    if cfg.ffn_density < 1.0:
        from ..sparse.layers import block_sparse_ffn_init

        return block_sparse_ffn_init(gen, cfg, dtype)
    return swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)


def _mlp_apply(p, x, cfg):
    if cfg.ffn_density < 1.0:
        from ..sparse.layers import block_sparse_ffn_apply

        return block_sparse_ffn_apply(p, x, cfg)
    act = gelu if cfg.gemma_norm else F.silu
    return swiglu_apply(p, x, act=act)


def block_init(gen, cfg, kind, dtype=torch.bfloat16):
    check_kind(kind)
    dev = gen.device
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": A.gqa_init(gen, cfg, dtype),
        "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": _mlp_init(gen, cfg, dtype),
    }
    if cfg.gemma_norm:
        p["ln1b"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["ln2b"] = rmsnorm_init(cfg.d_model, dtype, dev)
    return p


def _ffn(p, h, cfg):
    gn = cfg.gemma_norm
    f = _mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, gemma_style=gn), cfg)
    if gn:
        f = rmsnorm(p["ln2b"], f, gemma_style=True)
    return h + f


def block_apply(p, h, cfg, kind):
    """Full-sequence forward. Returns (h, cache) — cache for prefill reuse."""
    check_kind(kind)
    gn = cfg.gemma_norm
    a, kv = A.gqa_apply(
        p["attn"],
        rmsnorm(p["ln1"], h, gemma_style=gn),
        cfg,
        window=_window(cfg, kind),
        attn_cap=cfg.attn_softcap,
    )
    if gn:
        a = rmsnorm(p["ln1b"], a, gemma_style=True)
    return _ffn(p, h + a, cfg), kv


def block_decode(p, h, cache, cfg, kind):
    """One-token decode against this block's cache (stepped in place).
    Returns (h, cache)."""
    check_kind(kind)
    gn = cfg.gemma_norm
    a, cache = A.gqa_decode(
        p["attn"],
        rmsnorm(p["ln1"], h, gemma_style=gn),
        cache,
        cfg,
        window=_window(cfg, kind),
        attn_cap=cfg.attn_softcap,
    )
    if gn:
        a = rmsnorm(p["ln1b"], a, gemma_style=True)
    return _ffn(p, h + a, cfg), cache


def init_cache(cfg, kind, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero decode-cache for one block.  KV caches of sliding-window kinds
    are allocated at window size."""
    check_kind(kind)
    window = _window(cfg, kind)
    S = min(max_len, window) if window else max_len
    kv_shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return A.KVCache(torch.zeros(kv_shape, dtype=dtype, device=device),
                     torch.zeros(kv_shape, dtype=dtype, device=device), 0)
