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

On a process mesh (``core.sharding.set_mesh``) the block stream is
sharded over "model" as ``sparse_linear_spec`` places it: each rank holds
a contiguous run of ``nblocks / n`` blocks and runs the block kernel on its
run alone, with its own row pointer.  The pattern is row-balanced, so
where a run holds whole block-rows (the block-row count divides over
"model") the rank computes those rows and an all-gather over "model"
assembles y, bit for bit the whole stream's rows (in the FFN, the gate's
and up's rows meet in their product first: one all-gather of the hidden
activations, then one of the down-projection's output); where a run ends inside a
block-row, its row pointer spans every block-row, its rows elsewhere stay
zero, and a psum over "model" (in the accumulation dtype) merges the runs.
A stream whose block count does not divide is left whole on every rank
(``sanitize_shardings``), as in the reference.  Under autograd a rank's
grad x is its run's part of Wᵀ·gy, so x enters a run through
``common.model_in`` (its gradient summed over "model"), in both layouts;
Wᵀ's stream of a run of whole block-rows indexes the run's rows of gy
(its block-columns rebased by the run's first block-row, as the forward's
rows are).

Port-only keys (:data:`DERIVED`), beside the reference's three: the
block-row pointer the kernel walks (``browptr``, :func:`with_row_pointer`)
and Wᵀ's static stream (``t_perm``, ``t_browind``, ``t_bcolind``,
``t_browptr``, :func:`with_transpose`), built once when the layer is made
so that no pass rebuilds them.  On a mesh each projection also records
its run (:data:`RUN`, :func:`with_run`: the block-rows it computes, the
first of them and the merge), which the apply reads.  :func:`strip_derived`
removes them all (the optimizer state and checkpoints hold the reference's
tree) and :func:`with_derived` rebuilds them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import sharding as SH
from ..core.sharding import P
from ..kernels.bcsr_spmv import (bcoo_spmv, block_row_ptr, transposed_stream,
                                  transposed_values)
from ..models.common import model_in, normal, promoted

__all__ = [
    "sparse_linear_init",
    "sparse_linear_spec",
    "sparse_linear_apply",
    "blocks_per_row",
    "stream_layout",
    "with_run",
    "with_row_pointer",
    "with_transpose",
    "strip_derived",
    "with_derived",
    "DERIVED",
    "RUN",
    "BlockSpMM",
    "block_sparse_ffn_init",
    "block_sparse_ffn_spec",
    "block_sparse_ffn_apply",
]


def blocks_per_row(bcols: int, density: float) -> int:
    """The blocks in each block-row of the balanced pattern over ``bcols``
    block-columns at ``density``."""
    return max(1, int(round(bcols * density)))


def _balanced_pattern(brows: int, bcols: int, density: float, seed: int = 17):
    """Block mask with an equal number of blocks per block-row (perfect block
    balance across partitions — paper Rec. #2).  Static (numpy, fixed seed):
    the sparsity PATTERN is an architecture decision shared by all layers;
    only the block values are random per layer."""
    per_row = blocks_per_row(bcols, density)
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(bcols, per_row, replace=False)) for _ in range(brows)]
    browind = np.repeat(np.arange(brows, dtype=np.int32), per_row)
    bcolind = np.concatenate(rows).astype(np.int32)
    return browind, bcolind


def sparse_linear_spec():
    # block stream sharded over the model axis (equal blocks per rank: the
    # pattern is row-balanced)
    return {"browind": P("model"), "bcolind": P("model"),
            "bvalues": P("model", None, None)}


def block_sparse_ffn_spec(cfg):
    return {
        "w_gate": sparse_linear_spec(),
        "w_up": sparse_linear_spec(),
        "w_down": sparse_linear_spec(),
    }


def stream_layout(nb: int, d_in: int, d_out: int, block, density: float,
                  mesh=None) -> tuple:
    """(rows, lo, merge) of a rank's run of ``nb`` blocks of the balanced
    (d_out x d_in) pattern: the block-rows it computes (``rows`` of them
    from block-row ``lo``) and how the ranks' outputs merge: None (the
    whole stream), ``"gather"`` (whole block-rows: an all-gather over
    "model") or ``"psum"`` (a run ends inside a block-row: every block-row,
    summed over "model")."""
    r, c = block
    brows = d_out // r
    per_row = blocks_per_row(d_in // c, density)
    if nb == brows * per_row:
        return brows, 0, None
    if nb % per_row == 0:
        rows = nb // per_row
        return rows, SH.axis_index("model", mesh) * rows, "gather"
    return brows, 0, "psum"


# the merges of stream_layout, by the code RUN's third entry holds
MERGES = (None, "gather", "psum")
RUN = "brun"  # a rank's run on a mesh: (rows, lo, merge code), on the host


def with_run(p: dict, d_in: int, d_out: int, density: float, mesh=None) -> dict:
    """``p`` (the whole stream, or on ``mesh`` this rank's run of it) with
    the row pointer over the block-rows it computes and, on a mesh,
    :data:`RUN`: its :func:`stream_layout` as a host int64 tensor (one row
    per layer where the stream is stacked), which the apply reads."""
    r, c = p["bvalues"].shape[-2:]
    rows, lo, merge = stream_layout(p["bvalues"].shape[-3], d_in, d_out, (r, c),
                                    density, mesh)
    p = with_row_pointer(p, d_out, lo, rows)
    if mesh is not None:
        run = torch.tensor([rows, lo, MERGES.index(merge)], dtype=torch.int64)
        p[RUN] = run.expand(tuple(p["browind"].shape[:-1]) + (3,)).clone()
    return p


def with_row_pointer(p: dict, d_out: int, lo: int = 0, rows=None) -> dict:
    """``p`` with ``browptr``: the block-row pointer of its block stream,
    one row per layer where ``browind`` is stacked (NR, nb); over block-rows
    ``lo .. lo + rows`` (default: all of them) for a rank's run."""
    browind = p["browind"] - lo if lo else p["browind"]
    n_brows = d_out // p["bvalues"].shape[-2] if rows is None else rows
    if browind.ndim == 2:
        ptr = torch.stack([block_row_ptr(b, b.shape[0], n_brows) for b in browind])
    else:
        ptr = block_row_ptr(browind, browind.shape[0], n_brows)
    return dict(p, browptr=ptr)


def with_transpose(p: dict, d_in: int, lo: int = 0) -> dict:
    """``p`` with Wᵀ's static block stream (``t_perm``, ``t_browind``,
    ``t_bcolind``, ``t_browptr``; see ``kernels.bcsr_spmv.
    transposed_stream``), one row per layer where the stream is stacked.
    For a rank's run of block-rows from ``lo`` (:func:`with_run`), Wᵀ's
    block-columns are the run's rows, counted from ``lo``."""
    c = p["bvalues"].shape[-1]
    browind = p["browind"] - lo if lo else p["browind"]
    perm, t_browind, t_bcolind, t_browptr = transposed_stream(
        browind, p["bcolind"], d_in // c)
    return dict(p, t_perm=perm, t_browind=t_browind, t_bcolind=t_bcolind,
                t_browptr=t_browptr)


# the port-only keys of a sparse layer: derived from the reference's three
DERIVED = ("browptr", "t_perm", "t_browind", "t_bcolind", "t_browptr")


def strip_derived(tree):
    """``tree`` (nested dicts) with :data:`DERIVED` and :data:`RUN` removed
    from every sparse layer: the reference's tree, as optimizer state and
    checkpoints hold it."""
    if not isinstance(tree, dict):
        return tree
    sparse = "bvalues" in tree
    return {k: strip_derived(v) for k, v in tree.items()
            if not (sparse and (k in DERIVED or k == RUN))}


def _ffn_dims(cfg) -> dict:
    return {"w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
            "w_down": (cfg.d_ff, cfg.d_model)}


def with_derived(params: dict, cfg, mesh=None) -> dict:
    """An LM's params with :data:`DERIVED` rebuilt in every block-sparse FFN
    projection (prefix blocks, the stacked repeats, zamba2's shared block,
    the MTP block and the enc-dec encoder's stacked blocks alike; a block
    with an MoE FFN or a recurrent block has none).  With ``mesh``, each
    projection holds this rank's run of the stream, its row pointer covers
    the rows it computes, and :data:`RUN` records the run (see
    :func:`with_run`)."""
    if cfg.ffn_density >= 1.0:
        return params

    def one(q, d_in, d_out):
        q = with_run(q, d_in, d_out, cfg.ffn_density, mesh)
        lo = int(q[RUN].reshape(-1, 3)[0, 1]) if RUN in q else 0
        return with_transpose(q, d_in, lo)

    def block(blk):
        if "mlp" not in blk:
            return blk
        mlp = {name: one(blk["mlp"][name], d_in, d_out)
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

    On a process mesh the rank runs the block kernel on what it holds, the
    whole stream or its run of it, as ``p[RUN]`` (:func:`with_run`) says,
    and merges the ranks' outputs (see the module docstring).

    The block kernel's x is the contiguous (d_in, T) transpose of the
    activations, T = every leading position; it returns y (d_out, T) in
    the accumulation dtype, cast to the values' dtype and then to x's, as
    the reference's ``bcoo_spmv_ref(...).astype(x.dtype)`` does.
    Differentiable through :class:`BlockSpMM`.  Values and x of two float
    dtypes meet in the wider one, as the reference's accumulation dtype
    takes them (f32 activations are not rounded to bf16 blocks' dtype).
    """
    y, merge = _run_rows(p, x, d_out)
    if merge == "gather":
        y = SH.gather_dim(y, "model", y.ndim - 1)
    return y


def _run_rows(p, x, d_out: int) -> tuple:
    """(y, merge): the rows of W @ x this rank computes, (..., rows) in x's
    dtype, and how they still have to merge (None, or "gather" over
    "model"); a "psum" layout is summed here, in the accumulation dtype."""
    lead = x.shape[:-1]
    rows, merge = d_out, None
    if SH.get_abstract_mesh() is not None:
        if RUN not in p:
            raise ValueError("a sparse projection on a mesh needs its run's "
                             "layout: build it with with_derived(..., mesh)")
        n, lo, code = p[RUN].tolist()
        merge = MERGES[code]
        if merge == "gather":
            p, rows = dict(p, browind=p["browind"] - lo), n * p["bvalues"].shape[-2]
        x = model_in(x, merge is not None)  # the gate's and up's share one sum
    x2d, values = promoted(x.reshape(-1, x.shape[-1]), p["bvalues"])
    y = BlockSpMM.apply(values, x2d, p, rows)
    if merge == "psum":
        y, merge = SH.psum(y, "model"), None
    return y.to(p["bvalues"].dtype).T.reshape(lead + (rows,)).to(x.dtype), merge


def block_sparse_ffn_init(gen, cfg, dtype=torch.bfloat16):
    return {name: sparse_linear_init(gen, d_in, d_out, cfg.ffn_density,
                                     cfg.sparse_block, dtype)
            for name, (d_in, d_out) in _ffn_dims(cfg).items()}


def block_sparse_ffn_apply(p, x, cfg):
    """The sparse SwiGLU.  On a mesh where the gate's and up's runs hold
    whole block-rows (the same rows: one pattern), the product of the
    rank's rows is taken before the one all-gather over "model" that makes
    the hidden activations whole; then the down-projection's rows."""
    g, merge = _run_rows(p["w_gate"], x, cfg.d_ff)
    u, _ = _run_rows(p["w_up"], x, cfg.d_ff)
    h = F.silu(g) * u
    if merge == "gather":
        h = SH.gather_dim(h, "model", h.ndim - 1)
    return sparse_linear_apply(p["w_down"], h, cfg.d_model)
