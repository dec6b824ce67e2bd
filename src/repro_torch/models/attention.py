"""Attention: GQA (RoPE, optional bias / softcap / sliding window), with a
full-sequence path (prefill) and a one-token decode path against a KV
cache.

Counterpart of the GQA part of ``repro/models/attention.py``, in plain
torch ops that follow ``_sdpa`` step for step: scores in float32, masked
to -1e30, softmax, cast back.  No fused attention (``scaled_dot_product_
attention``) stands in: its numerics differ, and the JAX package has no
attention kernel to port.  MLA and cross-attention wait for their slices
(ROADMAP.md §1 items 3 and 5).

Two departures, both invisible in the results:

* ``KVCache.length`` is a Python int.  Every layer of a model holds the
  same length, and a tensor would make each ``slot`` / mask computation
  of :func:`gqa_decode` read the device once per layer per token.
* :func:`gqa_decode` writes the new token's K/V **into the cache it is
  given** (the reference copies functionally) and returns the same
  tensors in a new ``KVCache``: a cache that has been stepped must not be
  stepped again from its old length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .common import dense_apply, dense_bias_init, dense_init, rope, softcap

__all__ = ["KVCache", "gqa_init", "gqa_apply", "gqa_decode", "causal_mask",
           "CHUNKED_ATTN_THRESHOLD", "Q_CHUNK"]


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


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


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
    B, S, _ = x.shape
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(dense_apply(p["wq"], x), H, dh)
    k = _split_heads(dense_apply(p["wk"], x), KV, dh)
    v = _split_heads(dense_apply(p["wv"], x), KV, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0:
        out = _sdpa_qchunked(q, k, v, causal=causal, window=window,
                             cap=attn_cap, scale=cfg.attn_scale)
    else:
        mask = causal_mask(S, S, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask, cap=attn_cap, scale=cfg.attn_scale)
    out = dense_apply(p["wo"], out.reshape(B, S, H * dh))
    return out, KVCache(k, v, S)


def gqa_decode(p, x, cache: KVCache, cfg, *, window=None, attn_cap=None):
    """One-token decode: x (B, 1, d); cache holds ``length`` past tokens.

    The KV cache is pre-allocated at its static max length; the new token is
    written at position ``length``, in place.  For sliding-window archs the
    cache is allocated at window size and written round-robin.
    """
    B, _, _ = x.shape
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    Sk = cache.k.shape[1]
    pos = cache.length
    q = _split_heads(dense_apply(p["wq"], x), H, dh)
    k = _split_heads(dense_apply(p["wk"], x), KV, dh)
    v = _split_heads(dense_apply(p["wv"], x), KV, dh)
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
    out = dense_apply(p["wo"], out.reshape(B, 1, H * dh))
    return out, KVCache(cache.k, cache.v, pos + 1)
