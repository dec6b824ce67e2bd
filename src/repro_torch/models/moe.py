"""Mixture-of-Experts layers with SparseP-style sparse dispatch.

Counterpart of ``repro/models/moe.py``.  The token->expert assignment of
an MoE layer *is* a sparse matrix: rows are tokens, columns experts, with
top_k nonzeros per row.  Dispatch (gathering each expert's tokens) and
combine (scattering weighted outputs back) are the two SpMM halves of that
matrix:

  * dispatch sorts the assignment triplets by expert (the "row", a stable
    sort), then slots tokens into equal-capacity expert buffers — the
    equal-transfer-size padding of the paper.  Capacity overflow = dropped
    assignments (reported as padding efficiency).
  * the expert FFNs run as one batched GEMM over the expert axis
    (``torch.bmm``; the reference's einsums are plain XLA products too).
  * combine is the transposed SpMM: each token's weighted expert outputs
    summed back into its row.

Two routers: Mixtral (top-k of the logits, then softmax over them —
arXiv:2401.04088) and DeepSeek-V3 (sigmoid affinities plus a per-expert
bias for the selection, gates normalized over the selected set —
arXiv:2412.19437).

Dispatch groups: the reference groups the tokens by the batch shards of
the ambient mesh (``_n_batch_shards``: G = the extent of the batch axes,
1 without a mesh, and 1 where ``T % G`` or ``T // G < 8``), and slots each
group into its own buffers at ``moe_capacity(T / G)``: the same tokens
drop differently on a (2, 2) mesh than on one device, and so they do here.
Without a mesh there is one group and both of the reference's branches
compute the same contraction, ported once.  On a process mesh
(``core.sharding.set_mesh``) each rank slots one group (its batch block
when G is the batch axes' extent, every token when G = 1) and runs the
reference's branch for the arch, with ``moe_spec``'s placement:

* ``n_experts >= 64`` (deepseek): experts over the batch axes (expert
  parallelism), d over "model".  The group's tokens are sliced to this
  rank's d block before dispatch; an all-to-all over "data" takes the
  G-sharded slot buffers to E-sharded ones (with G = 1 every rank holds
  all the slots and keeps its experts'); the up-projections' f-space
  partial sums meet in a psum("model"); the down-projection lands d-sharded;
  an all-to-all takes the buffers back to G-sharded (an all-gather of the
  experts with G = 1); the combine runs on the d block and an all-gather
  over "model" makes d whole.
* otherwise (mixtral): tokens never move.  Each rank runs every expert on
  its group's slots; the experts' d storage dims are all-gathered over
  "data" and the f-space partials of the down-projection meet in a
  psum("model").

Under autograd the sharded branches are differentiable (``core/
sharding.py`` states the convention): the all-to-alls go back by the
reverse all-to-alls, the per-group gathers and slices over the batch axes
by their transposes, the psums("model") by the identity; what is
replicated over "model" and meets a product split over it enters through
``common.model_in`` (mixtral's tokens before the f-split experts;
deepseek's hidden activations before the d-split down-projection and its
gates, which the combine meets on the rank's d block).  The router's
weights are replicated: their gradients are summed over the batch axes
after the backward (``launch/steps.py``).

Two choices keep the port equal to the reference and deterministic:

* :func:`_top_k` is a stable descending sort, so ties go to the lower
  expert id, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
  order among ties).
* :func:`_local_combine` sums each token's contributions in a fixed
  order, ascending expert id, in x's dtype — the order in which the
  reference's scatter-add meets them.  No atomics: two runs on the card
  give the same bits, and with k = 8 bf16 sums the order shows.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import sharding as SH
from ..core.sharding import P
from .common import (batch_axes, dense_init, fsdp, model_in, normal,
                     swiglu_apply, swiglu_init, swiglu_spec)

__all__ = ["moe_init", "moe_spec", "moe_apply", "Routing", "EP_AXES",
           "dispatch_log"]


def moe_init(gen, cfg, dtype=torch.bfloat16):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, E, torch.float32, scale=0.02),
        "w_gate": normal(gen, (E, d, f), dtype, d ** -0.5),
        "w_up": normal(gen, (E, d, f), dtype, d ** -0.5),
        "w_down": normal(gen, (E, f, d), dtype, f ** -0.5),
    }
    if cfg.moe_router == "deepseek":  # aux-loss-free balance
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32, device=gen.device)
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts, dtype)
    return p


EP_AXES = ("pod", "data")  # expert-parallel axes == the batch-shard axes


def moe_spec(cfg) -> dict:
    if cfg.n_experts >= 64:
        # many small experts (deepseek): EP over the batch axes; d over
        # model on the up-projections' input and the down-projection's output
        expert_specs = {
            "w_gate": P(EP_AXES, "model", None),
            "w_up": P(EP_AXES, "model", None),
            "w_down": P(EP_AXES, None, "model"),
        }
    else:
        # few large experts (mixtral): experts replicated in compute; d over
        # the batch axes for storage, f over model
        expert_specs = {
            "w_gate": P(None, EP_AXES, "model"),
            "w_up": P(None, EP_AXES, "model"),
            "w_down": P(None, "model", EP_AXES),
        }
    sp = {"router": {"w": P(None, None)}, **expert_specs}
    if cfg.moe_router == "deepseek":
        sp["router_bias"] = P(None)
    if cfg.n_shared_experts:
        sp["shared"] = swiglu_spec()
    return sp


class Routing(NamedTuple):
    expert: torch.Tensor  # (T, k) int32 expert ids        — COO column indices
    weight: torch.Tensor  # (T, k) f32 combine gates       — COO values
    # (token index = COO row index, implicit by position)


def _router_logits(p, x):
    """f32 router logits.  The reference multiplies x by the router weight
    cast to x's dtype, with f32 products and sums; a bf16 ``matmul`` would
    round its output to bf16 and pick other experts, so the bf16-valued
    operands are multiplied in f32."""
    return torch.matmul(x.float(), p["router"]["w"].to(x.dtype).float())


def _top_k(scores, k: int):
    """(values, indices) of the k largest scores along the last axis, ties
    toward the lower index (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route_mixtral(p, x, k):
    w, idx = _top_k(_router_logits(p, x), k)  # (..., k) f32
    return Routing(idx.to(torch.int32), torch.softmax(w, dim=-1))


def _route_deepseek(p, x, k):
    """Sigmoid affinity + bias-adjusted selection, gates from raw affinities
    normalized over the selected set (DeepSeek-V3 §2.2, no aux loss)."""
    aff = torch.sigmoid(_router_logits(p, x))  # (..., E) f32
    _, idx = _top_k(aff + p["router_bias"], k)
    g = torch.gather(aff, -1, idx)
    w = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    return Routing(idx.to(torch.int32), w)


def _group_axes(cfg) -> tuple:
    """Dispatch-group mesh axes == the batch-shard axes."""
    return EP_AXES


def _n_batch_shards(axes) -> int:
    """Shard-group count over ``axes`` from the ambient mesh (1 without)."""
    return SH.axis_size(axes)


_LOG = []  # the open dispatch logs (dispatch_log), innermost last


@contextlib.contextmanager
def dispatch_log():
    """Record every group this process slots while the context is open: a
    list of dicts ``{"group", "groups", "capacity", "assigned", "kept",
    "dropped"}``, one per group and MoE layer call, in call order.
    Reading the counts waits for the device: for checks, not for timing."""
    log: list = []
    _LOG.append(log)
    try:
        yield log
    finally:
        _LOG.remove(log)


def _record(meta, group: int, groups: int, cap: int) -> None:
    if not _LOG:
        return
    keep = meta[3]
    kept = int(keep.sum())
    rec = {"group": group, "groups": groups, "capacity": cap,
           "assigned": int(keep.shape[0]), "kept": kept,
           "dropped": int(keep.shape[0]) - kept}
    for log in _LOG:
        log.append(rec)


def _local_dispatch(xg, eid, gate, E: int, cap: int):
    """Slot the tokens into per-expert buffers (gather form).

    xg: (T, d); eid/gate: (T*k,) in assignment order (token-major).
    Returns xbuf (E, cap, d) and the combine's metadata (asg_slot, tok_s,
    gate_s, keep), each in sorted-assignment order, array for array the
    reference's: the slot of assignment s is ``eid_s * cap + slot_of``,
    ``E * cap`` where the capacity dropped it.
    """
    T_k = eid.shape[0]
    k = T_k // xg.shape[0]  # assignments per token
    order = torch.sort(eid, stable=True).indices  # row-sort (format invariant)
    eid_s = eid[order]
    gate_s = gate[order]
    tok_s = (order // k).to(torch.int32)
    experts = torch.arange(E, dtype=eid_s.dtype, device=eid.device)
    first = torch.searchsorted(eid_s, experts, side="left")  # int64
    nxt = torch.cat([first[1:], first.new_tensor([T_k])])
    # slot (e, c) <- sorted assignment first[e] + c (valid while < next[e])
    pos = first[:, None] + torch.arange(cap, device=eid.device)[None, :]  # (E,cap)
    slot_valid = pos < nxt[:, None]
    src_tok = tok_s[torch.clamp(pos, 0, T_k - 1).reshape(-1)]
    xbuf = xg[src_tok]  # (E*cap, d)
    xbuf = torch.where(slot_valid.reshape(-1, 1), xbuf, torch.zeros((), dtype=xg.dtype,
                                                                    device=xg.device))
    # assignment -> its slot (for the combine gather); dropped -> E*cap
    slot_of = (torch.arange(T_k, device=eid.device)
               - first[torch.clamp(eid_s.long(), 0, E - 1)])
    keep = slot_of < cap  # capacity overflow -> dropped (padding efficiency)
    asg_slot = torch.where(keep, eid_s.long() * cap + slot_of,
                           torch.full_like(slot_of, E * cap)).to(torch.int32)
    return xbuf.reshape(E, cap, -1), (asg_slot, tok_s, gate_s, keep)


def _local_combine(ybuf, meta, T: int):
    """y (T, d): each token's kept contributions ``gate * ybuf[slot]``
    summed in x's dtype, in ascending expert order (the sorted assignment
    order the reference's scatter-add follows), starting from zero."""
    asg_slot, tok_s, gate_s, keep = meta
    E_cap = ybuf.shape[0] * ybuf.shape[1]
    flat = ybuf.reshape(E_cap, -1)
    contrib = flat[torch.clamp(asg_slot, 0, E_cap - 1)]
    zero = torch.zeros((), dtype=gate_s.dtype, device=gate_s.device)
    contrib = contrib * torch.where(keep, gate_s, zero)[:, None].to(contrib.dtype)
    # sorted assignment s belongs to token tok_s[s]; the stable sort keeps a
    # token's assignments in ascending expert order, so a stable sort of
    # tok_s lists each token's k contributions in that order
    by_tok = torch.sort(tok_s, stable=True).indices.reshape(T, -1)
    c = contrib[by_tok]  # (T, k, d)
    y = torch.zeros_like(c[:, 0])  # from +0, as the scatter-add: -0 sums to +0
    for j in range(c.shape[1]):
        y = y + c[:, j]
    return y


def _route(p, xg, cfg):
    """(eid, gate) of tokens xg (T, d), (T * k,) each in assignment order."""
    k = cfg.moe_top_k
    route = (_route_deepseek(p, xg, k) if cfg.moe_router == "deepseek"
             else _route_mixtral(p, xg, k))
    return route.expert.reshape(-1), route.weight.reshape(-1)


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (B, S, d); on a process mesh, this rank's batch
    block of it (see the module docstring)."""
    if SH.get_abstract_mesh() is not None:
        return _moe_apply_sharded(p, x, cfg)
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    cap = cfg.moe_capacity(T)
    xg = x.reshape(T, d)
    eid, gate = _route(p, xg, cfg)
    xbuf, meta = _local_dispatch(xg, eid, gate, E, cap)  # (E, cap, d)
    _record(meta, 0, 1, cap)
    h = F.silu(torch.bmm(xbuf, p["w_gate"])) * torch.bmm(xbuf, p["w_up"])
    ybuf = torch.bmm(h, p["w_down"]).to(x.dtype)
    y = _local_combine(ybuf, meta, T)
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], xg)
    return y.reshape(B, S, d).to(x.dtype)


def _moe_apply_sharded(p, x, cfg):
    """moe_apply on a process mesh: this rank's batch block x (B_loc, S, d)
    -> its block of the output."""
    B_loc, S, d = x.shape
    E = cfg.n_experts
    bax = batch_axes()
    split = SH.batch_split()
    B = SH.global_batch()
    T = B * S
    G = _n_batch_shards(_group_axes(cfg))
    if T % G or T // G < 8:  # tiny runs: a single group
        G = 1
    T_loc = T // G
    cap = cfg.moe_capacity(T_loc)
    g = SH.axis_index(bax) if G > 1 else 0
    # the tokens of this rank's group (T_loc, d)
    if G > 1:
        xg = x.reshape(T_loc, d) if split else \
            SH.slice_dim(x.reshape(G, T_loc, d), bax, 0)[0]
    else:
        xg = (SH.batch_unshard(x) if split else x).reshape(T, d)
    eid, gate = _route(p, xg, cfg)
    if E >= 64:
        y = _experts_ep(p, xg, eid, gate, cfg, G, g, cap, d, x.dtype)
    else:
        y = _experts_local(p, xg, eid, gate, cfg, G, g, cap, d, x.dtype)
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], xg,
                             d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    # back to this rank's batch block
    if G > 1 and not split:
        y = SH.gather_dim(y, bax, 0)  # every group: the whole batch
    elif G == 1 and split:
        y = SH.slice_dim(y.reshape(B, S, d), bax, 0)
    return y.reshape(B_loc, S, d).to(x.dtype)


def _experts_ep(p, xg, eid, gate, cfg, G, g, cap, d, dtype):
    """deepseek's branch: experts over the batch axes, d over "model"."""
    E, bax = cfg.n_experts, batch_axes()
    E_l, d_l = p["w_gate"].shape[0], p["w_gate"].shape[1]
    x_dispatch = SH.slice_dim(xg, "model", 1) if d_l < d else xg
    gate = model_in(gate, d_l < d)  # the combine meets it on the d block
    xbuf, meta = _local_dispatch(x_dispatch, eid, gate, E, cap)  # (E, cap, d_l)
    _record(meta, g, G, cap)
    buf = xbuf[None]  # (1, E, cap, d_l): this rank's group
    g_spec = bax if G > 1 else None  # the group dim: sharded or one group
    if E_l < E:  # G-sharded -> E-sharded: an all-to-all (a slice with G = 1)
        buf = SH.reshard(buf, P(g_spec), P(None, bax))
    Gx = buf.shape[0]
    xe = buf.transpose(0, 1).reshape(E_l, Gx * cap, d_l)
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    if d_l < d:  # f-space partials over the d blocks
        h, u = (SH.psum(t, "model") for t in (h, u))
    h = model_in(F.silu(h) * u, d_l < d)
    ybuf = torch.bmm(h, p["w_down"]).to(dtype)  # (E_l, Gx * cap, d_l)
    ybuf = ybuf.reshape(E_l, Gx, cap, -1).transpose(0, 1)
    if E_l < E:  # E-sharded -> G-sharded (an all-gather of E with G = 1)
        ybuf = SH.reshard(ybuf.contiguous(), P(None, bax), P(g_spec))
    y = _local_combine(ybuf[0], meta, xg.shape[0])  # (T_loc, d_l)
    return SH.gather_dim(y, "model", 1) if d_l < d else y


def _experts_local(p, xg, eid, gate, cfg, G, g, cap, d, dtype):
    """mixtral's branch: every expert on this rank's group; d gathered over
    the batch axes, the down-projection's f partials summed over "model"."""
    split_f = p["w_gate"].shape[-1] < cfg.moe_d_ff
    xbuf, meta = _local_dispatch(model_in(xg, split_f), eid, gate, cfg.n_experts,
                                 cap)  # (E, cap, d)
    _record(meta, g, G, cap)
    w_gate, w_up = fsdp(p["w_gate"], 1, d), fsdp(p["w_up"], 1, d)
    h = F.silu(torch.bmm(xbuf, w_gate)) * torch.bmm(xbuf, w_up)
    ybuf = torch.bmm(h, fsdp(p["w_down"], 2, d)).to(dtype)
    if split_f:
        ybuf = SH.psum(ybuf, "model")
    return _local_combine(ybuf, meta, xg.shape[0])
