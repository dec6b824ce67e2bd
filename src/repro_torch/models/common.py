"""Shared model components: norms, embeddings, RoPE, MLPs.

Counterpart of ``repro/models/common.py``.  Functional style, as there:
``*_init`` builds a param tree (nested dicts of tensors, with the JAX
tree's keys) from an explicit ``torch.Generator`` on the device the
params are to live on, and ``*_apply`` consumes it.  Each function does
the reference's arithmetic in the reference's order and dtypes.

The port has no mesh: the reference's ``shard`` / ``batch_shard`` and its
``*_spec`` functions wait for multi-card meshes (ROADMAP.md §1 item 7).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "map_params",
    "normal",
    "dense_init",
    "dense_bias_init",
    "promoted",
    "dense_apply",
    "rmsnorm_init",
    "rmsnorm",
    "embed_init",
    "rope",
    "softcap",
    "gelu",
    "swiglu_init",
    "swiglu_apply",
    "cross_entropy",
]


def map_params(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts with the same keys (the
    port's ``jax.tree.map`` for param trees)."""
    if isinstance(trees[0], dict):
        return {k: map_params(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """N(0, scale^2) draws from ``gen``, on ``gen``'s device, as ``dtype``
    (scaled in place: a full-width expert stack's f32 draw is 15 GB)."""
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal(gen, (d_in, d_out), dtype, scale)}


def dense_bias_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16):
    p = dense_init(gen, d_in, d_out, dtype)
    p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def promoted(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(x, w) in their common dtype, as ``jnp.einsum`` promotes its operands:
    float32 activations meeting bfloat16 weights compute in float32 (the
    encoder on f32 frames, cross-attention on f32 memory)."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def dense_apply(p, x):
    y = torch.matmul(*promoted(x, p["w"]))
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6, gemma_style: bool = False):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    norm = xf * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    scale = (1.0 + scale) if gemma_style else scale  # gemma2 stores (w - 1)
    return (norm * scale).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.bfloat16):
    return {"emb": normal(gen, (vocab, d), dtype, 0.02)}


# ---------------------------------------------------------------------------
# positional / activation helpers
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding. x: (..., S, H, Dh), positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None):
    """Gemma-2 logit soft capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (torch.tanh(x / cap) * cap).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu_init(gen, d: int, d_ff: int, dtype=torch.bfloat16):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def swiglu_apply(p, x, act=F.silu):
    h = act(dense_apply(p["w_gate"], x)) * dense_apply(p["w_up"], x)
    return dense_apply(p["w_down"], h)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Token cross-entropy in f32: logsumexp minus the gold logit, averaged
    over the tokens (over the masked-in tokens where ``mask`` is given)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
