"""SparsePLinear / BlockSparseFFN — the paper's formats as LM weight layers.

Counterpart of ``repro/sparse/layers.py``.  A BlockSparseFFN stores its
three SwiGLU projections as *block-sparse* BCOO weights at
``cfg.ffn_density`` with (r, c) blocks (``cfg.sparse_block``).  The
forward pass is the paper's BCOO SpMM with the activations as the dense
right-hand side: the port's block kernel (``kernels/bcsr_spmv.py:
bcoo_spmv``, ``csrc/bcoo_spmv.cu``) on a CUDA tensor, its plain version on
a CPU one.  The reference computes the same function with
``kref.bcoo_spmv_ref``.

The sparsity *pattern* is static per layer (numpy, fixed seed), balanced
across block-rows so the paper's block balancing is trivially perfect
(Rec. #2 applied at model-design time); only the block values are random
per layer.  Weights are stored densely per nonzero block: (nblocks, r, c)
plus block index arrays — the paper's BCOO (Fig. 2e).

Gradients: :func:`sparse_linear_apply` runs through :class:`BlockSpMM`,
a ``torch.autograd.Function``.  grad x = Wᵀ·gy is the block kernel again,
on the transposed block stream; grad bvalues[k] = gy[rows of k] ·
x[cols of k]ᵀ is a dense f32 ``torch.matmul(gy, xᵀ)`` followed by a
gather of the nonzero blocks (the JAX package differentiates
``kref.bcoo_spmv_ref``, plain ``jnp``, so no TPU kernel computes either).
The index arrays get no gradient.

Port-only keys (:data:`DERIVED`), beside the reference's three: the
block-row pointer the kernel walks (``browptr``, :func:`with_row_pointer`)
and Wᵀ's static stream (``t_perm``, ``t_browind``, ``t_bcolind``,
``t_browptr``, :func:`with_transpose`), built once when the layer is made
so that no pass rebuilds them.  :func:`strip_derived` removes them (the
optimizer state and checkpoints hold the reference's tree) and
:func:`with_derived` rebuilds them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.bcsr_spmv import (bcoo_spmv, block_row_ptr, transposed_stream,
                                  transposed_values)
from ..models.common import normal, promoted

__all__ = [
    "sparse_linear_init",
    "sparse_linear_apply",
    "with_row_pointer",
    "with_transpose",
    "strip_derived",
    "with_derived",
    "DERIVED",
    "BlockSpMM",
    "block_sparse_ffn_init",
    "block_sparse_ffn_apply",
]


def _balanced_pattern(brows: int, bcols: int, density: float, seed: int = 17):
    """Block mask with an equal number of blocks per block-row (perfect block
    balance across partitions — paper Rec. #2).  Static (numpy, fixed seed):
    the sparsity PATTERN is an architecture decision shared by all layers;
    only the block values are random per layer."""
    per_row = max(1, int(round(bcols * density)))
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(bcols, per_row, replace=False)) for _ in range(brows)]
    browind = np.repeat(np.arange(brows, dtype=np.int32), per_row)
    bcolind = np.concatenate(rows).astype(np.int32)
    return browind, bcolind


def with_row_pointer(p: dict, d_out: int) -> dict:
    """``p`` with ``browptr``: the block-row pointer of its block stream,
    one row per layer where ``browind`` is stacked (NR, nb)."""
    browind = p["browind"]
    n_brows = d_out // p["bvalues"].shape[-2]
    if browind.ndim == 2:
        ptr = torch.stack([block_row_ptr(b, b.shape[0], n_brows) for b in browind])
    else:
        ptr = block_row_ptr(browind, browind.shape[0], n_brows)
    return dict(p, browptr=ptr)


def with_transpose(p: dict, d_in: int) -> dict:
    """``p`` with Wᵀ's static block stream (``t_perm``, ``t_browind``,
    ``t_bcolind``, ``t_browptr``; see ``kernels.bcsr_spmv.
    transposed_stream``), one row per layer where the stream is stacked."""
    c = p["bvalues"].shape[-1]
    perm, t_browind, t_bcolind, t_browptr = transposed_stream(
        p["browind"], p["bcolind"], d_in // c)
    return dict(p, t_perm=perm, t_browind=t_browind, t_bcolind=t_bcolind,
                t_browptr=t_browptr)


# the port-only keys of a sparse layer: derived from the reference's three
DERIVED = ("browptr", "t_perm", "t_browind", "t_bcolind", "t_browptr")


def strip_derived(tree):
    """``tree`` (nested dicts) with :data:`DERIVED` removed from every sparse
    layer: the reference's tree, as optimizer state and checkpoints hold it."""
    if not isinstance(tree, dict):
        return tree
    sparse = "bvalues" in tree
    return {k: strip_derived(v) for k, v in tree.items()
            if not (sparse and k in DERIVED)}


def _ffn_dims(cfg) -> dict:
    return {"w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
            "w_down": (cfg.d_ff, cfg.d_model)}


def with_derived(params: dict, cfg) -> dict:
    """An LM's params with :data:`DERIVED` rebuilt in every block-sparse FFN
    projection (prefix blocks, the stacked repeats, zamba2's shared block,
    the MTP block and the enc-dec encoder's stacked blocks alike; a block
    with an MoE FFN or a recurrent block has none)."""
    if cfg.ffn_density >= 1.0:
        return params

    def block(blk):
        if "mlp" not in blk:
            return blk
        mlp = {name: with_transpose(with_row_pointer(blk["mlp"][name], d_out), d_in)
               for name, (d_in, d_out) in _ffn_dims(cfg).items()}
        return dict(blk, mlp=mlp)

    out = {k: block(v) if k.startswith("prefix") else v for k, v in params.items()}
    out["blocks"] = {k: block(v) for k, v in params["blocks"].items()}
    if "shared" in params:
        out["shared"] = block(params["shared"])
    if "mtp" in params:
        out["mtp"] = dict(params["mtp"], block=block(params["mtp"]["block"]))
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              blocks=block(params["encoder"]["blocks"]))
    return out


def sparse_linear_init(gen, d_in: int, d_out: int, density: float,
                       block=(8, 128), dtype=torch.bfloat16):
    """BCOO weight W (d_out x d_in) so y = W @ x maps to the paper's SpMV
    with x = activations. Stored transposed-for-SpMM: blocks index (out, in).
    """
    r, c = block
    if d_out % r or d_in % c:
        raise ValueError(f"({d_in} -> {d_out}) does not tile into {block} blocks")
    browind, bcolind = _balanced_pattern(d_out // r, d_in // c, density)
    nb = len(browind)
    scale = 1.0 / math.sqrt(d_in * density)
    p = {
        "browind": torch.from_numpy(browind).to(gen.device),
        "bcolind": torch.from_numpy(bcolind).to(gen.device),
        "bvalues": normal(gen, (nb, r, c), dtype, scale),
    }
    return with_transpose(with_row_pointer(p, d_out), d_in)


class BlockSpMM(torch.autograd.Function):
    """y (d_out, T) = W @ x2dᵀ for x2d (T, d_in), W the layer ``p``'s blocks,
    in the accumulation dtype; differentiable in ``bvalues`` and ``x2d``.

    Forward: ``bcoo_spmv`` on the contiguous (d_in, T) transpose of x2d
    (the block kernel on a CUDA tensor, its plain version on a CPU one).
    Backward, as JAX's transpose of ``kref.bcoo_spmv_ref``:
      grad x2d = (Wᵀ gy)ᵀ, ``bcoo_spmv`` on Wᵀ's static stream: one more
        block-kernel launch on the card;
      grad bvalues[k] = gy[rows of k] @ x2d[:, cols of k], summed over T in
        f32 and cast to the values' dtype: a dense f32 ``torch.matmul(gy,
        x2d)`` (d_out, d_in) and a gather of the nonzero blocks.  At
        density 0.5 that computes twice the needed products, in one call.
    The index arrays (``p``) get no gradient.
    """

    @staticmethod
    def forward(ctx, bvalues, x2d, p: dict, d_out: int):
        xt = x2d.T.contiguous()  # (d_in, T): the SpMM batch on the right
        y = bcoo_spmv(p["browind"], p["bcolind"], bvalues, xt, d_out,
                      browptr=p.get("browptr"))
        ctx.save_for_backward(bvalues, x2d)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, gy):
        bvalues, x2d = ctx.saved_tensors
        p = ctx.p
        nb, r, c = bvalues.shape
        d_out, d_in = gy.shape[0], x2d.shape[1]
        g_values = g_x = None
        if ctx.needs_input_grad[1]:
            missing = [k for k in DERIVED[1:] if k not in p]
            if missing:
                raise KeyError(f"sparse layer lacks Wᵀ's stream {missing}: build "
                               f"it with with_transpose / with_derived")
            # gy is f32 (the forward's y before its cast to the values'
            # dtype), but it is the cotangent of that cast: every element is
            # already a bf16 value when the values are bf16, so the kernel's
            # x in the values' dtype loses nothing
            gyc = gy.to(bvalues.dtype).contiguous()
            g_xt = bcoo_spmv(p["t_browind"], p["t_bcolind"],
                             transposed_values(bvalues, p["t_perm"]), gyc, d_in,
                             browptr=p["t_browptr"])  # (d_in, T)
            g_x = g_xt.T.to(x2d.dtype)
        if ctx.needs_input_grad[0]:
            dense = torch.matmul(gy.float(), x2d.float())  # (d_out, d_in)
            blocks = dense.view(d_out // r, r, d_in // c, c)
            g_values = blocks[p["browind"].long(), :, p["bcolind"].long(), :]
            g_values = g_values.to(bvalues.dtype)
        return g_values, g_x, None, None


def sparse_linear_apply(p, x, d_out: int):
    """y = W @ x for activations x (..., d_in) -> (..., d_out).

    The block kernel's x is the contiguous (d_in, T) transpose of the
    activations, T = every leading position; it returns y (d_out, T) in
    the accumulation dtype, cast to the values' dtype and then to x's, as
    the reference's ``bcoo_spmv_ref(...).astype(x.dtype)`` does.
    Differentiable through :class:`BlockSpMM`.  Values and x of two float
    dtypes meet in the wider one, as the reference's accumulation dtype
    takes them (f32 activations are not rounded to bf16 blocks' dtype).
    """
    lead = x.shape[:-1]
    x2d, values = promoted(x.reshape(-1, x.shape[-1]), p["bvalues"])
    y = BlockSpMM.apply(values, x2d, p, d_out)
    return y.to(p["bvalues"].dtype).T.reshape(lead + (d_out,)).to(x.dtype)


def block_sparse_ffn_init(gen, cfg, dtype=torch.bfloat16):
    return {name: sparse_linear_init(gen, d_in, d_out, cfg.ffn_density,
                                     cfg.sparse_block, dtype)
            for name, (d_in, d_out) in _ffn_dims(cfg).items()}


def block_sparse_ffn_apply(p, x, cfg):
    h = F.silu(sparse_linear_apply(p["w_gate"], x, cfg.d_ff))
    h = h * sparse_linear_apply(p["w_up"], x, cfg.d_ff)
    return sparse_linear_apply(p["w_down"], h, cfg.d_model)
