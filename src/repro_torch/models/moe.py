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

One device holds one dispatch group: the reference's ``_n_batch_shards``
is 1 without a mesh, and both of its branches (``n_experts >= 64`` or
not) then compute the same contraction, ported once here.  ``moe_spec``
and expert parallelism wait for multi-card meshes (ROADMAP.md §1 item 7).

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

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, normal, swiglu_apply, swiglu_init

__all__ = ["moe_init", "moe_apply", "Routing"]


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


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.moe_top_k, cfg.n_experts
    cap = cfg.moe_capacity(T)
    xg = x.reshape(T, d)
    route = (_route_deepseek(p, xg, k) if cfg.moe_router == "deepseek"
             else _route_mixtral(p, xg, k))
    eid = route.expert.reshape(T * k)
    gate = route.weight.reshape(T * k)
    xbuf, meta = _local_dispatch(xg, eid, gate, E, cap)  # (E, cap, d)
    h = F.silu(torch.bmm(xbuf, p["w_gate"])) * torch.bmm(xbuf, p["w_up"])
    ybuf = torch.bmm(h, p["w_down"]).to(x.dtype)
    y = _local_combine(ybuf, meta, T)
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], xg)
    return y.reshape(B, S, d).to(x.dtype)
