"""Gradient compression for cross-pod synchronization.

Counterpart of ``repro/optim/compress.py``: int8 error-feedback
compression.  Gradients are quantized per tensor and the quantization
residual is fed back the next step (standard EF-SGD).  On one device no
gradient crosses a link, so the step sees only the numerics: the
dequantized values and the residual, exactly as the reference's.  On a
process mesh (``compress_grads(..., mesh=)``) each rank compresses its
blocks at the whole leaf's scale: the max over every rank's block, one
all-gather of the ranks' maxima for the whole tree
(``core.sharding.world_max``), as the reference's per-tensor scale is
replicated (``P()``).
"""
from __future__ import annotations

import torch

from ..tree import flatten, leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "init_residual"]


def quantize_int8(g: torch.Tensor, amax=None):
    """int8 q and the f32 scale of ``g``; ``amax`` is the whole tensor's
    max |g| where ``g`` is a rank's block of it."""
    amax = torch.max(torch.abs(g)) if amax is None else amax
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, residual, mesh=None):
    """Error-feedback int8 compression: returns (dequantized grads in each
    grad's dtype, new residual).  On ``mesh`` the leaves are this rank's
    blocks and each is quantized at its whole leaf's scale."""

    def one(g, r, amax=None):
        gf = g.to(torch.float32) + r
        q, s = quantize_int8(gf, amax)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    flat_g, unflatten = flatten(grads)
    flat_r = leaves(residual)
    amax = [None] * len(flat_g)
    if mesh is not None and mesh.devices.size > 1:
        from ..core.sharding import world_max

        amax = world_max(torch.stack([torch.max(torch.abs(g.to(torch.float32) + r))
                                      for g, r in zip(flat_g, flat_r)]), mesh)
    out = [one(g, r, a) for g, r, a in zip(flat_g, flat_r, amax)]
    return unflatten(o[0] for o in out), unflatten(o[1] for o in out)
