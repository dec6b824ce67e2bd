"""AdamW with global-norm clipping and warmup-cosine LR.

Counterpart of ``repro/optim/adamw.py``, leaf for leaf.  The optimizer
state mirrors the parameter tree: ``m`` and ``v`` hold an f32 zero tensor
for every leaf, the integer (index) leaves included, as ``init_opt`` does
there; integer leaves are never updated.  Optionally a moment is kept in
int8 with a per-tensor scale (``quantized_m`` / ``quantized_v``), a
``{"q", "scale"}`` dict per leaf.

The step's scalar arithmetic (the schedule, the bias corrections) runs in
float32 tensors on the step counter's device, as JAX computes it without
x64: Python floats are float64 and would not match.  ``apply_updates(...,
donate=True)`` updates the state in place, as the reference's TrainLoop
donates it to its jitted step.

On a process mesh (``apply_updates(..., shardings=)``, the NamedSharding
tree of the params) every rank updates its blocks, and the two quantities
that span a whole leaf are taken across the ranks: the global norm (each
rank's sum of squares of a leaf weighted by one over the ranks that
replicate it, so every element counts once, then one psum over the mesh's
ranks) and an int8 moment's per-tensor scale (the max over every rank's
block: one all-gather of the ranks' maxima, ``core.sharding.world_max``),
whose spec is the reference's ``P()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import flatten, leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init_opt", "opt_specs", "apply_updates",
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


def opt_specs(param_specs, cfg: AdamWConfig):
    """Optimizer-state PartitionSpecs mirror the parameter specs (an int8
    moment's ``{"q", "scale"}`` pair: the param's spec and a scalar's)."""
    from ..core.sharding import P

    def q(tree):
        return tree_map(lambda s: {"q": s, "scale": P()}, tree,
                        is_leaf=lambda x: isinstance(x, P))

    m = q(param_specs) if cfg.quantized_m else param_specs
    v = q(param_specs) if cfg.quantized_v else param_specs
    return OptState(step=P(), m=m, v=v)


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


def _mesh_of(shardings):
    """The mesh of a NamedSharding tree where it has more than one rank."""
    if shardings is None:
        return None
    mesh = leaves(shardings, _is_sharding)[0].mesh
    return mesh if mesh.devices.size > 1 else None


def _is_sharding(x) -> bool:
    return hasattr(x, "spec") and hasattr(x, "mesh")


def _replicas(sh) -> int:
    """The ranks of ``sh``'s mesh that hold the same block."""
    split = 1
    for i in range(len(sh.spec)):
        split *= sh.extent(i)
    return sh.mesh.devices.size // split


def global_norm_clip(grads, max_norm: float, *, inplace: bool = False,
                     shardings=None):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``.  Returns
    (clipped grads, norm before clipping); ``inplace`` scales the given
    tensors a block at a time (the same values).  With ``shardings`` (a
    mesh's NamedSharding tree of the leaves) ``grads`` are this rank's
    blocks and the norm is the whole tree's."""
    flat, unflatten = flatten(grads)
    mesh = _mesh_of(shardings)
    if mesh is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in flat))
    else:
        from ..core.sharding import collectives

        shs = leaves(shardings, _is_sharding)
        sq = sum(torch.sum(torch.square(g.to(F32))) / _replicas(sh)
                 for g, sh in zip(flat, shs))
        gn = torch.sqrt(collectives(mesh).psum(sq, tuple(mesh.axis_names)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    if not inplace:
        return unflatten((g.to(F32) * scale).to(g.dtype) for g in flat), gn
    for g in flat:
        for flat_g, sl in _blocks(g):
            flat_g[sl] = (flat_g[sl].to(F32) * scale).to(g.dtype)
    return grads, gn


_BLOCK = 1 << 26  # elements of one block of an in-place update


def _blocks(t: torch.Tensor) -> list:
    """(flat view, slice) pairs covering a contiguous ``t`` in blocks of
    ``_BLOCK`` elements (the whole tensor where it is not contiguous): an
    elementwise update taken a block at a time gives the same values with
    one block's temporaries."""
    if not t.is_contiguous():
        return [(t, ...)]
    flat = t.view(-1)
    return [(flat, slice(i, i + _BLOCK)) for i in range(0, flat.numel(), _BLOCK)]


def _vq_decode(vq):
    return vq["q"].to(F32) * vq["scale"]


def _amax(v) -> torch.Tensor:
    # an empty leaf (the stack of a pattern with no repeats: deepseek cut
    # to its 3 prefix layers) takes the floor scale, where the reference's
    # ``jnp.max`` raises
    return torch.max(torch.abs(v)) if v.numel() else v.new_zeros(())


def _vq_encode(v, amax=None):
    """int8 ``q`` and the per-tensor ``scale`` of ``v``, from the leaf's
    max |v| (``amax``: the whole leaf's, where ``v`` is a rank's block)."""
    amax = _amax(v) if amax is None else amax
    scale = torch.clamp(amax / 127.0, min=1e-12)
    return {"q": torch.round(v / scale).to(torch.int8), "scale": scale}


def _is_vq(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def apply_updates(params, grads, opt: OptState, cfg: AdamWConfig, *,
                  donate: bool = False, shardings=None):
    """One AdamW step. Returns (new_params, new_opt, metrics).

    ``donate=True`` writes the clipped grads into ``grads`` and each leaf's
    new param and moments into the tensors of ``params`` and ``opt``, and
    returns trees of those tensors: the counterpart of the reference's
    TrainLoop donating both to its jitted step (XLA reuses their buffers).
    The state is then never held twice (a full-width mixtral layer's is 29
    GB), and with float32 moments a leaf is updated a block at a time,
    so its float32 temporaries stay small (a mixtral expert stack is 805M
    elements: 3.2 GB each).  ``shardings`` (the params' NamedSharding
    tree on a mesh) makes the norm and the int8 scales the whole leaves'."""
    grads, gnorm = global_norm_clip(grads, cfg.clip_norm, inplace=donate,
                                    shardings=shardings)
    mesh = _mesh_of(shardings)
    step = opt.step + 1
    lr = warmup_cosine(cfg, step)
    s = step.to(F32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, s.device), s)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, s.device), s)

    def new_values(p, g, m_f, v_f):
        g = g.to(F32)
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        update = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * update).to(p.dtype), m_f, v_f

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v  # structural (index) params: never updated
        if donate and not (cfg.quantized_m or cfg.quantized_v) and all(
                t.is_contiguous() for t in (p, m, v)):
            fp, fm, fv = (t.view(-1) for t in (p, m, v))
            fg = g.reshape(-1)
            for _, sl in _blocks(p):
                for dst, src in zip((fp, fm, fv), new_values(fp[sl], fg[sl], fm[sl],
                                                             fv[sl])):
                    dst[sl] = src
            return p, m, v
        return new_values(p, g, _vq_decode(m) if cfg.quantized_m else m,
                          _vq_decode(v) if cfg.quantized_v else v)

    def store(p, m, v, p_new, m_f, v_f, amax_m, amax_v):
        m_new = _vq_encode(m_f, amax_m) if cfg.quantized_m else m_f
        v_new = _vq_encode(v_f, amax_v) if cfg.quantized_v else v_f
        if donate:  # int8 moments: their scales need the whole leaf
            for dst, src in ((p, p_new), (m, m_new), (v, v_new)):
                for d, s_ in (zip(dst.values(), src.values()) if isinstance(dst, dict)
                              else [(dst, src)]):
                    d.copy_(s_)
            return p, m, v
        return p_new, m_new, v_new

    flat_p, unflatten = flatten(params)
    flat_g = leaves(grads)
    flat_m = leaves(opt.m, _is_vq if cfg.quantized_m else None)
    flat_v = leaves(opt.v, _is_vq if cfg.quantized_v else None)
    rows = list(zip(flat_p, flat_g, flat_m, flat_v))
    if not (cfg.quantized_m or cfg.quantized_v):
        out = [upd(*r) for r in rows]
    else:  # int8 moments: each leaf's new moments, encoded at its scale
        floats = [r for r in rows if r[0].is_floating_point()]
        amax = None
        if mesh is not None:  # the scales first: the whole leaves' maxima
            from ..core.sharding import world_max

            amax = world_max(torch.stack([_amax(t) for r in floats
                                          for t in upd(*r)[1:]]), mesh)
        out, j = [], 0
        for r in rows:
            if not r[0].is_floating_point():
                out.append((r[0], r[2], r[3]))  # structural: unchanged
                continue
            a = (None, None) if amax is None else (amax[2 * j], amax[2 * j + 1])
            out.append(store(r[0], r[2], r[3], *upd(*r), *a))
            j += 1
    new_p = unflatten(o[0] for o in out)
    new_m = unflatten(o[1] for o in out)
    new_v = unflatten(o[2] for o in out)
    return new_p, OptState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm,
        "lr": lr,
    }
