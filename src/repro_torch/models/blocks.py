"""Layer blocks: one (init, apply, decode, cache) bundle per block kind.

Counterpart of ``repro/models/blocks.py``:

  attn          pre-LN GQA + SwiGLU MLP (llama / qwen / smollm / llava)
  attn_local    gemma2 sliding-window layer (+ post-norms, softcaps)
  attn_global   gemma2 full-attention layer
  moe           GQA (optional SWA) + MoE FFN (mixtral)
  mla_dense     DeepSeek MLA + dense SwiGLU (prefix layers)
  mla_moe       DeepSeek MLA + 256-expert MoE
  mamba         Mamba2 SSD block (zamba2)
  shared_attn   zamba2's weight-shared attention+MLP block (the attn path)
  mlstm/slstm   xLSTM blocks
  cross_attn    enc-dec decoder layer: self-attn + cross-attn + MLP (seamless)

``cross_attn`` reads the encoder's output (``memory=``) in ``block_apply``
and ``block_decode``; every other kind takes the keyword and ignores it,
as in the reference.

The SparseP integration point: when cfg.ffn_density < 1, the dense MLP
(of the attention kinds, zamba2's shared block, ``mla_dense`` and the
enc-dec decoder's and encoder's layers) is
sparse/layers.py's BlockSparseFFN, whose three projections run on the
block kernel.  The MoE kinds' experts stay dense, as in the reference.

``block_spec`` is the reference's PartitionSpec tree per kind.  On a
process mesh (``core.sharding.set_mesh``) every kind runs its sharded
program: the attention kinds (``cross_attn``'s cross-attention included),
the recurrent kinds (``linear_attn``), the dense and block-sparse FFNs and
the MoE FFNs; under autograd each is differentiable, so every kind is
trained on a mesh too (``core/sharding.py`` states the gradients'
convention).  A "model" extent that would split a head raises
``NotImplementedError`` in the kind's own program: nothing is silently
replicated.

The attention kinds' caches are stepped in place by ``block_decode``; the
recurrent kinds (``mamba``, ``mlstm``, ``slstm``) return a new state, which
``lm.decode_step`` copies into the stacked caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sharding import P
from . import attention as A
from . import linear_attn as LA
from . import moe as M
from .common import (gelu, rmsnorm, rmsnorm_init, swiglu_apply, swiglu_init,
                     swiglu_spec)

__all__ = ["block_init", "block_spec", "block_apply", "block_decode",
           "init_cache", "check_kind", "KINDS", "MESH_KINDS"]

_GQA_KINDS = ("attn", "attn_local", "attn_global", "moe", "shared_attn")
_CROSS = "cross_attn"
_MLA_KINDS = ("mla_dense", "mla_moe")
# recurrent kind -> (its params' key, init, apply, decode)
_RECURRENT = {
    "mamba": ("mamba", LA.mamba2_init, LA.mamba2_apply, LA.mamba2_decode),
    "mlstm": ("mlstm", LA.mlstm_init, LA.mlstm_apply, LA.mlstm_decode),
    "slstm": ("slstm", LA.slstm_init, LA.slstm_apply, LA.slstm_decode),
}
KINDS = _GQA_KINDS + _MLA_KINDS + tuple(_RECURRENT) + (_CROSS,)
# the kinds with a sharded program on a process mesh, served and trained
# there: every kind
MESH_KINDS = KINDS


def check_kind(kind: str) -> None:
    """Raise ``ValueError`` for a block kind the reference does not have."""
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _window(cfg, kind):
    if kind == "attn_global":
        return None
    return cfg.sliding_window  # attn_local / moe (mixtral SWA) / plain and shared attn


def _mlp_init(gen, cfg, dtype):
    if cfg.ffn_density < 1.0:
        from ..sparse.layers import block_sparse_ffn_init

        return block_sparse_ffn_init(gen, cfg, dtype)
    return swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)


def _mlp_spec(cfg):
    if cfg.ffn_density < 1.0:
        from ..sparse.layers import block_sparse_ffn_spec

        return block_sparse_ffn_spec(cfg)
    return swiglu_spec()


def _mlp_apply(p, x, cfg):
    if cfg.ffn_density < 1.0:
        from ..sparse.layers import block_sparse_ffn_apply

        return block_sparse_ffn_apply(p, x, cfg)
    act = gelu if cfg.gemma_norm else F.silu
    return swiglu_apply(p, x, act=act, d_ff=cfg.d_ff)


def block_init(gen, cfg, kind, dtype=torch.bfloat16):
    check_kind(kind)
    dev = gen.device
    if kind in _RECURRENT:
        key, init, _, _ = _RECURRENT[kind]
        return {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
                key: init(gen, cfg, dtype)}
    if kind in _MLA_KINDS:
        p = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
             "mla": A.mla_init(gen, cfg, dtype),
             "ln2": rmsnorm_init(cfg.d_model, dtype, dev)}
    else:
        p = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
             "attn": A.gqa_init(gen, cfg, dtype)}
        if kind == _CROSS:
            p["ln_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
            p["xattn"] = A.gqa_init(gen, cfg, dtype)
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
    if kind in ("moe", "mla_moe"):
        p["moe"] = M.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = _mlp_init(gen, cfg, dtype)
    if cfg.gemma_norm and kind in _GQA_KINDS:
        p["ln1b"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["ln2b"] = rmsnorm_init(cfg.d_model, dtype, dev)
    return p


def block_spec(cfg, kind):
    ln = {"scale": P(None)}
    if kind in ("attn", "attn_local", "attn_global", "shared_attn"):
        sp = {"ln1": ln, "attn": A.gqa_spec(cfg), "ln2": ln, "mlp": _mlp_spec(cfg)}
        if cfg.gemma_norm:
            sp["ln1b"] = ln
            sp["ln2b"] = ln
        return sp
    if kind == "cross_attn":
        return {"ln1": ln, "attn": A.gqa_spec(cfg), "ln_x": ln,
                "xattn": A.gqa_spec(cfg), "ln2": ln, "mlp": _mlp_spec(cfg)}
    if kind == "moe":
        return {"ln1": ln, "attn": A.gqa_spec(cfg), "ln2": ln, "moe": M.moe_spec(cfg)}
    if kind == "mla_dense":
        return {"ln1": ln, "mla": A.mla_spec(cfg), "ln2": ln, "mlp": _mlp_spec(cfg)}
    if kind == "mla_moe":
        return {"ln1": ln, "mla": A.mla_spec(cfg), "ln2": ln, "moe": M.moe_spec(cfg)}
    if kind == "mamba":
        return {"ln1": ln, "mamba": LA.mamba2_spec(cfg)}
    if kind == "mlstm":
        return {"ln1": ln, "mlstm": LA.mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln1": ln, "slstm": LA.slstm_spec(cfg)}
    raise ValueError(kind)


def _ffn(p, h, cfg, kind):
    gn = cfg.gemma_norm and kind in _GQA_KINDS
    hin = rmsnorm(p["ln2"], h, gemma_style=gn)
    f = (M.moe_apply(p["moe"], hin, cfg) if "moe" in p
         else _mlp_apply(p["mlp"], hin, cfg))
    if gn:
        f = rmsnorm(p["ln2b"], f, gemma_style=True)
    return h + f


def _cross(p, h, memory, cfg):
    """The cross_attn kind's second sublayer: pre-LN cross-attention over
    the encoder's ``memory`` (on a mesh, this rank's batch rows of it),
    added to the residual."""
    return h + A.cross_attn_apply(p["xattn"], rmsnorm(p["ln_x"], h), memory, cfg)


def block_apply(p, h, cfg, kind, memory=None):
    """Full-sequence forward. Returns (h, cache) — cache for prefill reuse.
    ``memory`` (B, S_enc, d) is the encoder's output, read by cross_attn."""
    check_kind(kind)
    if kind == _CROSS:  # no window, softcap or gemma norms, as the reference
        a, kv = A.gqa_apply(p["attn"], rmsnorm(p["ln1"], h), cfg)
        return _ffn(p, _cross(p, h + a, memory, cfg), cfg, kind), kv
    if kind in _RECURRENT:
        key, _, apply, _ = _RECURRENT[kind]
        y, state = apply(p[key], rmsnorm(p["ln1"], h), cfg)
        return h + y, state
    if kind in _MLA_KINDS:
        a, cache = A.mla_apply(p["mla"], rmsnorm(p["ln1"], h), cfg)
        return _ffn(p, h + a, cfg, kind), cache
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
    return _ffn(p, h + a, cfg, kind), kv


def block_decode(p, h, cache, cfg, kind, memory=None):
    """One-token decode against this block's cache.  Returns (h, cache):
    an attention cache stepped in place, or a recurrent kind's new state
    (the one given is left as it was).  cross_attn reads ``memory``."""
    check_kind(kind)
    if kind == _CROSS:
        a, cache = A.gqa_decode(p["attn"], rmsnorm(p["ln1"], h), cache, cfg)
        return _ffn(p, _cross(p, h + a, memory, cfg), cfg, kind), cache
    if kind in _RECURRENT:
        key, _, _, decode = _RECURRENT[kind]
        y, state = decode(p[key], rmsnorm(p["ln1"], h), cache, cfg)
        return h + y, state
    if kind in _MLA_KINDS:
        a, cache = A.mla_decode(p["mla"], rmsnorm(p["ln1"], h), cache, cfg)
        return _ffn(p, h + a, cfg, kind), cache
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
    return _ffn(p, h + a, cfg, kind), cache


def init_cache(cfg, kind, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero decode-cache for one block.  KV caches of sliding-window kinds
    are allocated at window size; MLA's latent cache at max_len; the
    recurrent kinds' float32 states are O(1) in the length."""
    check_kind(kind)
    if kind == "mamba":
        dh = cfg.ssm_d_inner // cfg.ssm_heads
        return LA.RecurrentState(
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, dh),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state),
                        dtype=torch.float32, device=device))
    if kind == "mlstm":
        dh = cfg.d_model // cfg.n_heads
        return LA.RecurrentState(
            torch.zeros((batch, cfg.n_heads, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32, device=device))
    if kind == "slstm":
        return LA.slstm_zero_state(batch, cfg, device)
    if kind in _MLA_KINDS:
        return A.MLACache(
            torch.zeros((batch, max_len, cfg.mla_kv_comp), dtype=dtype, device=device),
            torch.zeros((batch, max_len, cfg.mla_rope_dim), dtype=dtype, device=device),
            0)
    window = _window(cfg, kind)
    S = min(max_len, window) if window else max_len
    kv_shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return A.KVCache(torch.zeros(kv_shape, dtype=dtype, device=device),
                     torch.zeros(kv_shape, dtype=dtype, device=device), 0)
