"""Attention: GQA (RoPE, optional bias / softcap / sliding window), MLA
(DeepSeek-V3 latent attention), each with a full-sequence path (prefill)
and a one-token decode path against a cache, and the enc-dec decoder's
cross-attention over encoder memory.

Counterpart of ``repro/models/attention.py``, in plain torch ops that
follow ``_sdpa`` / ``_mla_attend`` step for step: scores in float32,
masked to -1e30, softmax, cast back.  No fused attention
(``scaled_dot_product_attention``) stands in: its numerics differ, and the
JAX package has no attention kernel to port.

On a process mesh (``core.sharding.set_mesh``) the heads are local to
their "model" rank, as ``gqa_spec`` / ``mla_spec`` place the projections:
q, k and v are column-parallel products (this rank's heads), the output
projection a row-parallel one (partial sums, then a psum over "model"),
and the KV cache holds this rank's heads (``lm.cache_specs``: heads over
"model").  Where the heads do not divide over "model" (or the weights
were left whole), q, k and v are gathered whole and every rank computes
every head.  MLA's latents ``ckv`` (B, S, d_c) and ``krope`` are whole on
every rank (``cq`` and ``ckv`` are all-gathered over "model" after their
column-parallel products): every local head attends over all of d_c, so
the cache a rank holds is its batch block of the whole latent, not the
d_c block over "model" that ``lm.cache_specs`` names.

Under autograd the input enters the column-parallel q/k/v and latent
products through ``common.model_in`` (its gradient summed over "model"),
and so do MLA's whole latents ``ckv`` and rope key where the rank attends
with its own heads; the output projection is ``row_apply``'s.

Two departures, both invisible in the results:

* ``KVCache.length`` / ``MLACache.length`` is a Python int.  Every layer
  of a model holds the same length, and a tensor would make each
  ``slot`` / mask computation of a decode read the device once per layer
  per token.
* :func:`gqa_decode` and :func:`mla_decode` write the new token's entry
  **into the cache they are given** (the reference copies functionally)
  and return the same tensors in a new cache: a cache that has been
  stepped must not be stepped again from its old length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from torch.utils.checkpoint import checkpoint

from ..core import sharding as SH
from ..core.sharding import P
from .common import (col_apply, dense_bias_init, dense_init,
                     dense_spec, fsdp, model_full, model_in, rope, row_apply,
                     softcap)

__all__ = ["KVCache", "MLACache", "gqa_init", "gqa_spec", "gqa_apply",
           "gqa_decode", "mla_init", "mla_spec", "mla_apply", "mla_decode",
           "cross_attn_apply", "causal_mask", "CHUNKED_ATTN_THRESHOLD", "Q_CHUNK"]


class KVCache(NamedTuple):
    k: torch.Tensor  # ([NR,] B, S, n_kv, dh)
    v: torch.Tensor  # ([NR,] B, S, n_kv, dh)
    length: int  # tokens already in the cache (the same in every layer)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg, dtype=torch.bfloat16):
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qkv_bias."""
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    mk = dense_bias_init if cfg.qkv_bias else dense_init
    return {
        "wq": mk(gen, cfg.d_model, H * dh, dtype),
        "wk": mk(gen, cfg.d_model, KV * dh, dtype),
        "wv": mk(gen, cfg.d_model, KV * dh, dtype),
        "wo": dense_init(gen, H * dh, cfg.d_model, dtype),
    }


def gqa_spec(cfg) -> dict:
    sp = {
        "wq": dense_spec("col"),
        "wk": dense_spec("col"),
        "wv": dense_spec("col"),
        "wo": dense_spec("row"),
    }
    if cfg.qkv_bias:
        for k in ("wq", "wk", "wv"):
            sp[k] = dict(sp[k], b=P("model"))
    return sp


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _heads_local(n_heads: int, *projected) -> bool:
    """Whether this rank computes its own heads: every head count divides
    over "model" and every projection came out as this rank's block."""
    n = SH.axis_size("model")
    return n > 1 and all(h % n == 0 for h in n_heads) \
        and all(y.shape[-1] < full for y, full in projected)


def _qkv(p, x, cfg, kv_x=None):
    """q, k, v split into heads: this rank's heads where they divide over
    "model", every head otherwise.  k and v are projected from ``kv_x``
    where given (cross-attention's memory), else from x."""
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kv_x = x if kv_x is None else kv_x
    q, k, v = (col_apply(p[n], a, w) for n, a, w in
               (("wq", x, H * dh), ("wk", kv_x, KV * dh), ("wv", kv_x, KV * dh)))
    if not _heads_local((H, KV), (q, H * dh), (k, KV * dh), (v, KV * dh)):
        q, k, v = model_full(q, H * dh), model_full(k, KV * dh), model_full(v, KV * dh)
    return (_split_heads(q, q.shape[-1] // dh, dh), _split_heads(k, k.shape[-1] // dh, dh),
            _split_heads(v, v.shape[-1] // dh, dh))


def _sdpa(q, k, v, mask, cap=None, scale=None):
    """q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh) with H % KV == 0."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qf = q.float() * (scale if scale is not None else 1.0 / math.sqrt(dh))
    qg = qf.reshape(B, Sq, KV, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    logits = softcap(logits, cap)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


# Above this sequence length, full-sequence attention runs query-chunked so
# live scores stay O(q_chunk * S).  Both are read at call time.
CHUNKED_ATTN_THRESHOLD = 4096
Q_CHUNK = 1024


def _sdpa_qchunked(q, k, v, *, causal, window, cap, scale, q_chunk=None):
    """Query-chunked attention: a loop over query chunks of ``q_chunk``
    (default :data:`Q_CHUNK`), each against every key."""
    q_chunk = Q_CHUNK if q_chunk is None else q_chunk
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    if Sq % q_chunk:
        raise ValueError(f"sequence {Sq} is not a multiple of q_chunk {q_chunk}")
    kpos = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for off in range(0, Sq, q_chunk):
        m = None
        if causal:
            qpos = off + torch.arange(q_chunk, device=q.device)[:, None]
            m = kpos <= qpos
            if window is not None:
                m = m & (kpos > qpos - window)
            m = m[None, None, None]
        outs.append(_sdpa(q[:, off:off + q_chunk], k, v, m, cap=cap, scale=scale))
    return torch.cat(outs, dim=1)


def causal_mask(Sq: int, Sk: int, window: int | None = None, device=None):
    """(1, 1, 1, Sq, Sk) boolean mask; optional sliding window."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None, None]


def gqa_apply(p, x, cfg, *, window=None, positions=None, attn_cap=None,
              causal=True):
    """Full-sequence attention (prefill). Returns (out, KVCache)."""
    B, S, d = x.shape
    dh, H = cfg.head_dim, cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0:
        out = _sdpa_qchunked(q, k, v, causal=causal, window=window,
                             cap=attn_cap, scale=cfg.attn_scale)
    else:
        mask = causal_mask(S, S, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask, cap=attn_cap, scale=cfg.attn_scale)
    out = row_apply(p["wo"], out.reshape(B, S, -1), H * dh, d)
    return out, KVCache(k, v, S)


def gqa_decode(p, x, cache: KVCache, cfg, *, window=None, attn_cap=None):
    """One-token decode: x (B, 1, d); cache holds ``length`` past tokens.

    The KV cache is pre-allocated at its static max length; the new token is
    written at position ``length``, in place.  For sliding-window archs the
    cache is allocated at window size and written round-robin.
    """
    B, _, d = x.shape
    dh, H = cfg.head_dim, cfg.n_heads
    Sk = cache.k.shape[1]
    pos = cache.length
    q, k, v = _qkv(p, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    slot = pos % Sk if window is not None else min(pos, Sk - 1)
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    # Window case: the ring buffer is fully valid once pos >= Sk; before that
    # only slots <= current are populated.
    last = Sk - 1 if pos >= Sk else slot
    mask = (torch.arange(Sk, device=x.device) <= last)[None, None, None, None, :]
    out = _sdpa(q, cache.k, cache.v, mask, cap=attn_cap, scale=cfg.attn_scale)
    out = row_apply(p["wo"], out.reshape(B, 1, -1), H * dh, d)
    return out, KVCache(cache.k, cache.v, pos + 1)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V3 Multi-head Latent Attention (arXiv:2412.19437 §2.1)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, dtype=torch.bfloat16):
    """Latent attention: KV compressed to d_kv_comp (=512), Q to d_q_comp
    (=1536); decoupled RoPE keys of dim d_rope (=64)."""
    d, H = cfg.d_model, cfg.n_heads
    dc, dq, dr, dh = cfg.mla_kv_comp, cfg.mla_q_comp, cfg.mla_rope_dim, cfg.head_dim
    return {
        "w_dq": dense_init(gen, d, dq, dtype),  # q down
        "w_uq": dense_init(gen, dq, H * dh, dtype),  # q up (nope part)
        "w_qr": dense_init(gen, dq, H * dr, dtype),  # q rope part
        "w_dkv": dense_init(gen, d, dc, dtype),  # kv joint down
        "w_kr": dense_init(gen, d, dr, dtype),  # shared rope key
        "w_uk": dense_init(gen, dc, H * dh, dtype),  # k up
        "w_uv": dense_init(gen, dc, H * dh, dtype),  # v up
        "wo": dense_init(gen, H * dh, d, dtype),
    }


def mla_spec(cfg) -> dict:
    return {
        "w_dq": dense_spec("col"),
        "w_uq": dense_spec("col"),
        "w_qr": dense_spec("col"),
        "w_dkv": dense_spec("col"),
        "w_kr": dense_spec("replicated"),
        "w_uk": dense_spec("col"),
        "w_uv": dense_spec("col"),
        "wo": dense_spec("row"),
    }


class MLACache(NamedTuple):
    ckv: torch.Tensor  # ([NR,] B, S, d_kv_comp) — compressed latent (the MLA win)
    krope: torch.Tensor  # ([NR,] B, S, d_rope)
    length: int  # tokens already in the cache (the same in every layer)


def _mla_attend(p, q_nope, q_rope, ckv, krope, cfg, mask):
    """Attention against compressed latents, in float32.

    Absorbed form: score = q_nope^T (W_uk c) + q_rope^T k_rope; value = W_uv c.
    The score tensor is built and normalized in place (the reference's
    arithmetic in its order): at S = 4,096 with 128 heads each copy is
    8.6 GB.
    """
    B, Sq, H, dh = q_nope.shape
    dr = cfg.mla_rope_dim
    k_nope = _mla_up(p["w_uk"]["w"], H, cfg)
    v_up = _mla_up(p["w_uv"]["w"], H, cfg)
    scale = 1.0 / math.sqrt(dh + dr)
    # q_nope absorbed into latent space: (B,Sq,H,dc)
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope.float(), k_nope.float())
    logits = torch.einsum("bqhc,bsc->bhqs", q_lat, ckv.float())
    logits += torch.einsum("bqhr,bsr->bhqs", q_rope.float(), krope.float())
    logits *= scale
    if mask is not None:
        logits.masked_fill_(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    del logits
    out_lat = torch.einsum("bhqs,bsc->bqhc", w, ckv.float())
    out = torch.einsum("bqhc,chd->bqhd", out_lat, v_up.float())
    return out.to(q_nope.dtype)


def _mla_up(w, H: int, cfg):
    """An up-projection (d_c, heads * dh) as (d_c, H, dh) for the ``H``
    heads this rank computes: d_c whole (FSDP-gathered), and the heads
    gathered over "model" where this rank holds a block of them but
    computes every head."""
    w = fsdp(w, 0, cfg.mla_kv_comp)
    if w.shape[1] < H * cfg.head_dim:
        w = model_full(w, cfg.n_heads * cfg.head_dim)
    return w.reshape(cfg.mla_kv_comp, H, cfg.head_dim)


def _mla_q(p, x, cfg):
    """(q_nope, q_rope) split into this rank's heads (every head where
    they do not divide over "model"), the latents ckv whole and the rope
    key, for ``x`` (B, S, d)."""
    B, S, _ = x.shape
    H, dh, dr = cfg.n_heads, cfg.head_dim, cfg.mla_rope_dim
    cq = model_full(col_apply(p["w_dq"], x, cfg.mla_q_comp), cfg.mla_q_comp)
    q_nope = col_apply(p["w_uq"], cq, H * dh)
    q_rope = col_apply(p["w_qr"], cq, H * dr)
    uk, uv = p["w_uk"]["w"], p["w_uv"]["w"]
    local = _heads_local((H,), (q_nope, H * dh), (q_rope, H * dr),
                         (uk, H * dh), (uv, H * dh))
    if not local:
        q_nope, q_rope = model_full(q_nope, H * dh), model_full(q_rope, H * dr)
    ckv = model_full(col_apply(p["w_dkv"], x, cfg.mla_kv_comp), cfg.mla_kv_comp)
    kr = col_apply(p["w_kr"], x, dr)
    # the rank's heads attend over the whole latents: their gradients are
    # the heads' parts
    ckv, kr = model_in(ckv, local), model_in(kr, local)
    return (q_nope.reshape(B, S, -1, dh), q_rope.reshape(B, S, -1, dr), ckv, kr)


def _mla_chunk(p, qn, qr, ckv, krope, cfg, off: int):
    """One query chunk of :func:`mla_apply`'s chunked path: queries
    ``off .. off + len`` against every key, causally masked."""
    qpos = off + torch.arange(qn.shape[1], device=qn.device)[:, None]
    m = (torch.arange(ckv.shape[1], device=qn.device)[None, :] <= qpos)[None, None]
    return _mla_attend(p, qn, qr, ckv, krope, cfg, m)


def mla_apply(p, x, cfg, *, positions=None):
    """Full-sequence MLA (prefill). Returns (out, MLACache).

    At ``S >= CHUNKED_ATTN_THRESHOLD`` with ``S % Q_CHUNK == 0`` (both read
    at call time) the queries run in chunks of ``Q_CHUNK`` against every
    key; under autograd each chunk is recomputed in the backward pass
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
    """
    B, S, d = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, ckv, kr = _mla_q(p, x, cfg)  # ckv: (B, S, dc)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    krope = rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0:
        outs = []
        for off in range(0, S, Q_CHUNK):
            args = (p, q_nope[:, off:off + Q_CHUNK], q_rope[:, off:off + Q_CHUNK],
                    ckv, krope, cfg, off)
            if torch.is_grad_enabled():  # flash-style: recompute in backward
                outs.append(checkpoint(SH.in_this_scope(_mla_chunk), *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                outs.append(_mla_chunk(*args))
        out = torch.cat(outs, dim=1)
    else:
        mask = causal_mask(S, S, device=x.device)[:, :, 0]  # logits are (B, H, q, s)
        out = _mla_attend(p, q_nope, q_rope, ckv, krope, cfg, mask)
    out = row_apply(p["wo"], out.reshape(B, S, -1), H * dh, d)
    return out, MLACache(ckv, krope, S)


def mla_decode(p, x, cache: MLACache, cfg):
    """One-token decode: x (B, 1, d); the new latent and rope key are
    written at ``min(length, max_len - 1)``, in place (past ``max_len`` the
    last slot is overwritten, as the reference does)."""
    B, _, d = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    pos = cache.length
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, kr = _mla_q(p, x, cfg)
    q_rope = rope(q_rope, posb, cfg.rope_theta)
    kr_new = rope(kr[:, :, None, :], posb, cfg.rope_theta)[:, :, 0, :]
    Sk = cache.ckv.shape[1]
    slot = min(pos, Sk - 1)
    cache.ckv[:, slot] = ckv_new[:, 0].to(cache.ckv.dtype)
    cache.krope[:, slot] = kr_new[:, 0].to(cache.krope.dtype)
    mask = (torch.arange(Sk, device=x.device) <= slot)[None, None, None, :]
    out = _mla_attend(p, q_nope, q_rope, cache.ckv, cache.krope, cfg, mask)
    out = row_apply(p["wo"], out.reshape(B, 1, -1), H * dh, d)
    return out, MLACache(cache.ckv, cache.krope, pos + 1)


# ---------------------------------------------------------------------------
# cross attention (enc-dec; seamless-m4t)
# ---------------------------------------------------------------------------


def cross_attn_apply(p, x, memory, cfg):
    """Decoder cross-attention over encoder memory (B, Sm, d): no RoPE, no
    mask, never query-chunked.  K and V are projected from ``memory`` on
    every call, decode steps included, as in the reference (no cross-KV
    cache).  f32 memory meets bf16 weights in f32; the output takes x's
    dtype.  On a mesh ``memory`` holds this rank's batch rows and every
    feature; the rank attends with its heads, as :func:`gqa_apply` does.
    Under autograd the memory enters k and v through ``model_in``, cached
    on it, so its gradient is summed over "model" once for every decoder
    layer that reads it, after the layers' parts have added up."""
    B, S, d = x.shape
    q, k, v = _qkv(p, x, cfg, memory)
    out = _sdpa(q, k, v, None, scale=cfg.attn_scale)
    return row_apply(p["wo"], out.reshape(B, S, -1), cfg.n_heads * cfg.head_dim, d)
