"""AdamW with global-norm clipping and warmup-cosine LR.

Counterpart of ``repro/optim/adamw.py``, leaf for leaf.  The optimizer
state mirrors the parameter tree: ``m`` and ``v`` hold an f32 zero tensor
for every leaf, the integer (index) leaves included, as ``init_opt`` does
there; integer leaves are never updated.  Optionally a moment is kept in
int8 with a per-tensor scale (``quantized_m`` / ``quantized_v``), a
``{"q", "scale"}`` dict per leaf.

The step's scalar arithmetic (the schedule, the bias corrections) runs in
float32 tensors on the step counter's device, as JAX computes it without
x64: Python floats are float64 and would not match.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import flatten, leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "warmup_cosine", "global_norm_clip"]

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized_v: bool = False  # int8 second moment (large-model memory)
    quantized_m: bool = False  # int8 first moment (8-bit-Adam style)


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # f32, mirrors params
    v: Any  # f32 or {"q": int8, "scale": f32} per leaf


def _q_zeros(p):
    return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "scale": torch.ones((), dtype=F32, device=p.device)}


def _zeros(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def init_opt(params, cfg: AdamWConfig) -> OptState:
    """Zero moments for every leaf of ``params``; the step counter (an int32
    scalar) lies on the first leaf's device."""
    m = tree_map(_q_zeros if cfg.quantized_m else _zeros, params)
    v = tree_map(_q_zeros if cfg.quantized_v else _zeros, params)
    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=m, v=v)


def _f32(value, device) -> torch.Tensor:
    return torch.full((), value, dtype=F32, device=device)


def warmup_cosine(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (an int or an int tensor), as an f32 scalar
    tensor: linear warmup, then a cosine to 0 at ``total_steps``."""
    step = torch.as_tensor(step)
    dev = step.device
    s = step.to(F32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), dev), _f32(1.0, dev))
    prog = torch.clamp(
        (s - _f32(cfg.warmup_steps, dev))
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    return (_f32(cfg.lr_peak, dev) * warm * _f32(0.5, dev)
            * (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * prog)))


def global_norm_clip(grads, max_norm: float):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``.  Returns
    (clipped grads, norm before clipping)."""
    flat, unflatten = flatten(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return unflatten((g.to(F32) * scale).to(g.dtype) for g in flat), gn


def _vq_decode(vq):
    return vq["q"].to(F32) * vq["scale"]


def _vq_encode(v):
    scale = torch.clamp(torch.max(torch.abs(v)) / 127.0, min=1e-12)
    return {"q": torch.round(v / scale).to(torch.int8), "scale": scale}


def _is_vq(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def apply_updates(params, grads, opt: OptState, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_opt, metrics)."""
    grads, gnorm = global_norm_clip(grads, cfg.clip_norm)
    step = opt.step + 1
    lr = warmup_cosine(cfg, step)
    s = step.to(F32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, s.device), s)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, s.device), s)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v  # structural (index) params: never updated
        g = g.to(F32)
        m_f = _vq_decode(m) if cfg.quantized_m else m
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = _vq_decode(v) if cfg.quantized_v else v
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        update = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.to(F32)
        p_new = (p.to(F32) - lr * update).to(p.dtype)
        m_new = _vq_encode(m_f) if cfg.quantized_m else m_f
        v_new = _vq_encode(v_f) if cfg.quantized_v else v_f
        return p_new, m_new, v_new

    flat_p, unflatten = flatten(params)
    flat_g = leaves(grads)
    flat_m = leaves(opt.m, _is_vq if cfg.quantized_m else None)
    flat_v = leaves(opt.v, _is_vq if cfg.quantized_v else None)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = unflatten(o[0] for o in out)
    new_m = unflatten(o[1] for o in out)
    new_v = unflatten(o[2] for o in out)
    return new_p, OptState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm,
        "lr": lr,
    }
