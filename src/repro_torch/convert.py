"""Carry state across from the JAX package, handed over as numpy arrays.

The JAX package's containers (``repro.core.formats``) and chunk plans
(``repro.kernels.coo_spmv.ChunkPlan``) are frozen dataclasses whose fields
are arrays or static metadata.  Given each field as ``np.asarray(field)``,
the functions here build the port's counterparts, array for array, so that
both packages can run on identical inputs.  bfloat16 arrays (ml_dtypes)
are taken by bit view.  Nothing of the JAX package is imported.
"""
from __future__ import annotations

import numpy as np

from .core import formats as F
from .kernels.coo_spmv import ChunkPlan

__all__ = ["container", "chunk_plan"]

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
