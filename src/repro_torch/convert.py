"""Carry state across from the JAX package, handed over as numpy arrays.

The JAX package's containers (``repro.core.formats``) and chunk plans
(``repro.kernels.coo_spmv.ChunkPlan``) are frozen dataclasses whose fields
are arrays or static metadata.  Given each field as ``np.asarray(field)``,
the functions here build the port's counterparts, array for array, so that
both packages can run on identical inputs.  The same holds for an LM's
parameter tree (nested dicts of arrays, ``repro.models.lm.init_params``).
bfloat16 arrays (ml_dtypes) are taken by bit view.  Nothing of the JAX
package is imported.
"""
from __future__ import annotations

import numpy as np

from .core import formats as F
from .kernels.coo_spmv import ChunkPlan
from .models.common import map_params
from .sparse.layers import with_derived

__all__ = ["container", "chunk_plan", "lm_params"]

_KINDS = {"csr": F.CSR, "coo": F.COO, "bcsr": F.BCSR, "bcoo": F.BCOO}
_STATIC = {"shape": tuple, "block": tuple, "nnz": int, "nblocks": int,
           "n_windows": int, "out_rows": int, "span": int}


def _field(name: str, value):
    if name in _STATIC:
        return _STATIC[name](np.asarray(value).tolist())
    return F.to_tensor(value)


def container(kind: str, fields: dict):
    """The port's ``kind`` container ("csr" | "coo" | "bcsr" | "bcoo") from
    the JAX container's fields as numpy arrays."""
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown container kind {kind!r}") from None
    return cls(**{k: _field(k, v) for k, v in fields.items()})


def chunk_plan(fields: dict) -> ChunkPlan:
    """The port's :class:`ChunkPlan` from the JAX one's fields as numpy
    arrays (``window_start`` is derived)."""
    return ChunkPlan(**{k: _field(k, v) for k, v in fields.items()})


def lm_params(tree: dict, cfg, mesh=None) -> dict:
    """The port's LM params (CPU tensors) from the JAX package's tree as
    numpy arrays, key for key and dtype for dtype (MoE, MLA and MTP
    subtrees, zamba2's unstacked ``shared`` block and the recurrent blocks'
    float32 leaves — Mamba2's ``a_log`` / ``d_skip``, sLSTM's ``r`` — in bf16
    trees included).  Block-sparse FFN layers keep ``browind`` /
    ``bcolind`` / ``bvalues`` unchanged and gain the port-only keys
    (``sparse.layers.DERIVED``: ``browptr`` and Wᵀ's stream), the shared
    block's too.

    With a process ``mesh``, the full leaves are cut to this rank's blocks
    as ``lm.param_specs`` places them on it (``runtime.elastic.
    make_shardings`` then ``sanitize_shardings``), and the port-only keys
    are built for the rank's runs of the block streams."""
    full = map_params(F.to_tensor, tree)
    if mesh is None:
        return with_derived(full, cfg)
    return with_derived(shard_params(full, cfg, mesh), cfg, mesh)


def param_shardings(cfg, mesh, like):
    """The sanitized NamedSharding tree of ``lm.param_specs(cfg)`` on
    ``mesh`` for the leaves of ``like`` (the reference's tree: full
    tensors, fake or real)."""
    from .models import lm
    from .runtime.elastic import make_shardings, sanitize_shardings

    return sanitize_shardings(make_shardings(mesh, lm.param_specs(cfg)), like)


def shard_params(full: dict, cfg, mesh, device=None) -> dict:
    """This rank's blocks of a full param tree (the reference's keys)."""
    from .runtime.elastic import shard_tree

    return shard_tree(full, param_shardings(cfg, mesh, full), device)
