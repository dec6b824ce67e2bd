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

One key more than the reference's tree: ``browptr``, the block-row
pointer the kernel walks, built once from ``browind`` when the layer is
made (:func:`with_row_pointer`), so that no forward pass rebuilds it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.bcsr_spmv import bcoo_spmv, block_row_ptr
from ..models.common import normal

__all__ = [
    "sparse_linear_init",
    "sparse_linear_apply",
    "with_row_pointer",
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
    return with_row_pointer(p, d_out)


def sparse_linear_apply(p, x, d_out: int):
    """y = W @ x for activations x (..., d_in) -> (..., d_out).

    The block kernel's x is the contiguous (d_in, T) transpose of the
    activations, T = every leading position; it returns y (d_out, T) in
    the accumulation dtype, cast to the values' dtype and then to x's, as
    the reference's ``bcoo_spmv_ref(...).astype(x.dtype)`` does.
    """
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1]).T.contiguous()  # (d_in, T): SpMM batch
    y = bcoo_spmv(p["browind"], p["bcolind"], p["bvalues"], xt, d_out,
                  browptr=p.get("browptr"))  # (d_out, T)
    return y.to(p["bvalues"].dtype).T.reshape(lead + (d_out,)).to(x.dtype)


def block_sparse_ffn_init(gen, cfg, dtype=torch.bfloat16):
    d, f, dens, blk = cfg.d_model, cfg.d_ff, cfg.ffn_density, cfg.sparse_block
    return {
        "w_gate": sparse_linear_init(gen, d, f, dens, blk, dtype),
        "w_up": sparse_linear_init(gen, d, f, dens, blk, dtype),
        "w_down": sparse_linear_init(gen, f, d, dens, blk, dtype),
    }


def block_sparse_ffn_apply(p, x, cfg):
    h = F.silu(sparse_linear_apply(p["w_gate"], x, cfg.d_ff))
    h = h * sparse_linear_apply(p["w_up"], x, cfg.d_ff)
    return sparse_linear_apply(p["w_down"], h, cfg.d_model)
