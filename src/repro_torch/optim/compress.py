"""Gradient compression for cross-pod synchronization.

Counterpart of ``repro/optim/compress.py``: int8 error-feedback
compression.  Gradients are quantized per tensor and the quantization
residual is fed back the next step (standard EF-SGD).  On one device no
gradient crosses a link, so the step sees only the numerics: the
dequantized values and the residual, exactly as the reference's.
"""
from __future__ import annotations

import torch

from ..tree import flatten, leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "init_residual"]


def quantize_int8(g: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, residual):
    """Error-feedback int8 compression: returns (dequantized grads in each
    grad's dtype, new residual)."""

    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    flat_g, unflatten = flatten(grads)
    out = [one(g, r) for g, r in zip(flat_g, leaves(residual))]
    return unflatten(o[0] for o in out), unflatten(o[1] for o in out)
