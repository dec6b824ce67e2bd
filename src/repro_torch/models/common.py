"""Shared model components: norms, embeddings, RoPE, MLPs.

Counterpart of ``repro/models/common.py``.  Functional style, as there:
``*_init`` builds a param tree (nested dicts of tensors, with the JAX
tree's keys) from an explicit ``torch.Generator`` on the device the
params are to live on, and ``*_apply`` consumes it.  Each function does
the reference's arithmetic in the reference's order and dtypes.

Sharding, on a process mesh (``core/mesh.py: ProcessMesh``) installed with
``core.sharding.set_mesh``: the ``*_spec`` functions are the reference's
PartitionSpec trees (``core.sharding.P``), entry for entry, and every rank
holds its block of each param as they place it.  Where the reference's
``shard`` lets GSPMD insert a collective, the sharded program here calls
it: a column-parallel weight (out dim on "model") is a local product
(:func:`col_apply`); a row-parallel one (in dim on "model") a local
product and a ``psum("model")`` (:func:`row_apply`); a weight dim stored
over "data" (FSDP) is all-gathered over "data" before use (:func:`fsdp`).
Without a mesh every function is the one-device program it was, with no
collective.  Activations between blocks are (batch block, S, d) on every
rank: a block of the batch over the batch axes where they divide it, and
every feature.

Under autograd the sharded program is differentiable (``core/sharding.py``
states the convention): an activation replicated over "model" enters a
column-parallel product through ``sharding.model_in`` (its gradient summed
over "model"), the FSDP all-gathers' gradients are psum-scattered over the
batch axes, and :func:`cross_entropy` is the mean over the global batch.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core import sharding as SH
from ..core.sharding import P

__all__ = [
    "batch_axes",
    "shard",
    "batch_shard",
    "dense_spec",
    "embed_spec",
    "swiglu_spec",
    "fsdp",
    "model_block",
    "model_full",
    "col_apply",
    "row_apply",
    "model_in",
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


# Merged batch axes: filtered to the ambient mesh's axes at call time.
_BATCH_AXES = ("pod", "data")


def batch_axes(mesh=None) -> tuple:
    """The mesh axes the batch dimension shards over."""
    mesh = SH.get_abstract_mesh() if mesh is None else mesh
    names = mesh.axis_names if mesh is not None else ()
    return tuple(a for a in _BATCH_AXES if a in names)


def shard_spec(shape, *spec) -> P:
    """The reference's ``shard`` rules on the ambient mesh: entries naming
    axes the mesh lacks are dropped, and so are entries whose extent does
    not divide the dimension."""
    mesh = SH.get_abstract_mesh()
    names = mesh.axis_names if mesh is not None else ()

    def _filter(entry, dim):
        axes = tuple(a for a in SH.entry_axes(entry) if a in names)
        if not axes:
            return None
        extent = SH.axis_size(axes, mesh)
        if extent == 0 or dim % extent:
            return None
        return axes if isinstance(entry, (tuple, list)) else axes[0]

    return P(*(_filter(e, d) for e, d in zip(spec, shape)))


def shard(x: torch.Tensor, *spec, src=()) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (cleaned as
    :func:`shard_spec` does) from its block under ``src`` (default:
    replicated); ``x`` itself without a mesh."""
    if SH.get_abstract_mesh() is None:
        return x
    return SH.reshard(x, src, shard_spec(x.shape, *spec))


def batch_shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (the leading dim over
    pod+data where they divide it)."""
    return SH.batch_shard(x)


def dense_spec(kind: str = "col") -> dict:
    """Megatron-style TP specs: col-parallel (out dim on model), row-parallel
    (in dim on model); the other dim carries FSDP over data."""
    if kind == "col":
        return {"w": P("data", "model")}
    if kind == "row":
        return {"w": P("model", "data")}
    if kind == "replicated":
        return {"w": P(None, None)}
    raise ValueError(kind)


def embed_spec() -> dict:
    # vocab-parallel only (the reference's: a masked local gather and a
    # psum over model)
    return {"emb": P("model", None)}


def swiglu_spec() -> dict:
    return {
        "w_gate": dense_spec("col"),
        "w_up": dense_spec("col"),
        "w_down": dense_spec("row"),
    }


# ---------------------------------------------------------------------------
# the sharded program's pieces (identities without a mesh)
# ---------------------------------------------------------------------------


def fsdp(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``w`` with its ``dim`` whole: all-gathered over the batch axes where
    this rank stores a block of it (FSDP)."""
    if w.shape[dim] == full:
        return w
    return SH.gather_dim(w, batch_axes(), dim)


def model_block(x: torch.Tensor, full: int) -> torch.Tensor:
    """This rank's "model" block of x's last dim (of ``full``), from x
    whole or already a block."""
    if SH.get_abstract_mesh() is None or x.shape[-1] < full:
        return x
    return SH.slice_dim(x, "model", x.ndim - 1)


def model_full(x: torch.Tensor, full: int) -> torch.Tensor:
    """x's last dim whole: all-gathered over "model" where x holds this
    rank's block of it."""
    if x.shape[-1] == full:
        return x
    return SH.gather_dim(x, "model", x.ndim - 1)


def model_in(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """``x`` as it enters a product split over "model" (``split``):
    ``sharding.model_in``, the identity whose gradient is summed over
    "model"; ``x`` itself without a mesh or where nothing is split."""
    if not split or SH.get_abstract_mesh() is None:
        return x
    return SH.model_in(x)


def col_apply(p, x, d_out: int | None = None):
    """A column-parallel dense on x with every feature: the weight's in
    dim whole (FSDP-gathered), its out dim this rank's block where it is
    split over "model" (so is the output's last dim, bias included).  On a
    mesh ``d_out`` (the whole out dim) says whether it is: then x enters
    through :func:`model_in`."""
    w = fsdp(p["w"], 0, x.shape[-1])
    if d_out is not None:
        x = model_in(x, w.shape[-1] < d_out)
    y = torch.matmul(*promoted(x, w))
    if "b" in p:
        y = y + p["b"]
    return y


def row_apply(p, x, d_in: int, d_out: int):
    """A row-parallel dense: the weight's out dim whole (FSDP-gathered);
    where its in dim is split over "model", the product of x's block of
    ``d_in`` with it, summed over "model" (psum); else x whole times it."""
    w = fsdp(p["w"], 1, d_out)
    if w.shape[0] < d_in:
        y = torch.matmul(*promoted(model_block(x, d_in), w))
        return SH.psum(y, "model")
    return torch.matmul(*promoted(model_full(x, d_in), w))


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


def rmsnorm(p, x, eps: float = 1e-6, gemma_style: bool = False, d=None):
    """RMS norm over x's last dim.  On a mesh ``d`` (the whole feature dim)
    says whether x holds only this rank's "model" block of it (a rank's
    heads): then the mean of squares is the rank's partial sum, psummed
    over "model" (one (..., 1) tensor, no gather of the features), and the
    rank scales its features by its slice of the replicated ``scale``.
    The sum enters the rank's features through :func:`model_in`, so its
    gradient is summed over "model" and the psum's passes through."""
    xf = x.float()
    if d is not None and x.shape[-1] < d:
        part = torch.sum(xf * xf, dim=-1, keepdim=True)
        var = model_in(SH.psum(part, "model")) / d
        scale = model_block(p["scale"], d).float()
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        scale = p["scale"].float()
    norm = xf * torch.rsqrt(var + eps)
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


def swiglu_apply(p, x, act=F.silu, d_ff=None):
    """SwiGLU.  On a mesh ``d_ff`` (the hidden width) is required: the
    hidden activations are this rank's "model" block of it where the
    weights split it, and the down-projection's partial sums meet in a
    psum("model")."""
    h = act(col_apply(p["w_gate"], x, d_ff)) * col_apply(p["w_up"], x, d_ff)
    return row_apply(p["w_down"], h, h.shape[-1] if d_ff is None else d_ff,
                     x.shape[-1])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Token cross-entropy in f32: logsumexp minus the gold logit, averaged
    over the tokens (over the masked-in tokens where ``mask`` is given).

    On a mesh, ``logits`` and ``labels`` are this rank's batch block and
    the mean is the global batch's, as the reference's: the rank's sum of
    the losses and its token count, one psum of the two over the batch
    axes where the batch is split, then their quotient."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if SH.get_abstract_mesh() is None:
        if mask is not None:
            nll = nll * mask
            return nll.sum() / torch.clamp(mask.sum(), min=1)
        return nll.mean()
    if mask is not None:
        total, count = (nll * mask).sum(), mask.sum().float()
    else:
        total = nll.sum()
        count = torch.full((), nll.numel(), dtype=torch.float32, device=nll.device)
    both = torch.stack([total, count])
    if SH.batch_split():
        both = SH.psum(both, batch_axes())
    if mask is not None:
        return both[0] / torch.clamp(both[1], min=1)
    return both[0] / both[1]
