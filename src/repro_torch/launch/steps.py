"""Step builders for train / prefill / decode:

  * make_train_step(cfg, opt_cfg)  -> f(params, opt, batch)
                                      -> (params, opt, metrics)
  * make_prefill_step(cfg, shape)  -> f(params, batch) -> (logits, caches)
  * make_decode_step(cfg, shape)   -> f(params, batch) -> (logits, caches)

Counterpart of ``repro/launch/steps.py``'s ``_value_and_grad_trainable``
and step builders.  The reference jits each step; the port runs it
eagerly on the params' device.  An enc-dec arch's prefill step encodes
``batch["frames"]``; its decode step reads ``batch["memory"]`` (the
encoder's output, kept by the caller), and its train batch carries
``frames``, which ``lm.loss_fn`` encodes.

``input_specs`` and ``abstract_state`` are the reference's on fake tensors
(``FakeTensorMode``, CPU): the dry run's inputs and train state, with
nothing allocated.  ``batch_spec``, ``cache_specs``,
``input_spec_shardings`` and ``state_specs`` are the reference's
PartitionSpec trees (``core.sharding.P``), entry for entry.

On a process mesh (the step called under ``core.sharding.set_mesh``, as
``TrainLoop(mesh=)`` does) the params and the optimizer state are the
rank's blocks (``state_specs`` through ``make_shardings`` +
``sanitize_shardings``), the batch is the global one on every rank, and
``lm.loss_fn`` keeps the rank's rows.  After each backward the gradient
of every float leaf that its spec leaves replicated over the batch axes
(norms, biases, routers, a vocab-only embedding) is summed over them where
the batch is split, one psum per dtype for all of them
(:func:`sum_replicated_grads`); a leaf split over the batch axes (FSDP,
experts) has its sum from the backward's psum-scatters.  Microbatch ``i``
is block ``i`` of the global batch, as the reference splits it, so a rank
holds its rows of that block.  The update then takes the norm and the
int8 scales over the whole leaves (``optim.apply_updates(...,
shardings=)``).

A sparse LM's port-only keys (``sparse.layers.DERIVED``) ride along with
the params: the loss reads them, the optimizer never sees them (its state
holds the reference's tree), and the updated params carry them over.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core import sharding as SH
from repro_torch.core.sharding import P
from repro_torch.models import attention as A
from repro_torch.models import linear_attn as LA
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, OptState, apply_updates, init_opt,
                               opt_specs)
from repro_torch.sparse.layers import strip_derived
from repro_torch.tree import flatten, tree_map

__all__ = ["value_and_grad_trainable", "make_train_step", "make_prefill_step",
           "make_decode_step", "carry_derived", "input_specs", "abstract_state",
           "loss_and_grads", "sum_replicated_grads", "mesh_param_shardings",
           "BATCH_AXES", "batch_spec", "input_spec_shardings", "cache_specs",
           "state_specs"]

BATCH_AXES = ("pod", "data")


def batch_spec(*trailing):
    return P(BATCH_AXES, *trailing)


def value_and_grad_trainable(loss_fn):
    """(loss, grads) of ``loss_fn(params, *args)`` over the float leaves only.

    Integer leaves (the BCOO index arrays of sparse layers) are structural,
    not trainable: they are held fixed and receive zero gradients so the
    optimizer tree stays congruent.  A float leaf the loss does not reach
    also gets zeros, as ``jax.grad`` gives.
    """

    def wrapped(params, *args):
        flat, unflatten = flatten(params)
        train = [x.detach().requires_grad_() if x.is_floating_point() else x
                 for x in flat]
        with torch.enable_grad():
            loss = loss_fn(unflatten(train), *args)
            wrt = [x for x in train if x.is_floating_point()]
            grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        g_flat = []
        for x in train:
            g = next(grads) if x.is_floating_point() else None
            g_flat.append(torch.zeros_like(x) if g is None else g)
        return loss.detach(), unflatten(g_flat)

    return wrapped


def carry_derived(new, old):
    """``new`` (the reference's tree) with every key of ``old`` that it
    lacks (the port-only keys of sparse layers) carried over unchanged."""
    if not isinstance(new, dict):
        return new
    out = {k: carry_derived(v, old[k]) for k, v in new.items()}
    out.update({k: v for k, v in old.items() if k not in new})
    return out


def mesh_param_shardings(cfg: ArchConfig, mesh):
    """The sanitized NamedSharding tree of ``lm.param_specs(cfg)`` on
    ``mesh`` (the reference's tree, no port-only keys), made once per
    config and kept on the mesh (``Mesh.memo``), so it goes with it."""
    memo = mesh.memo.setdefault("param_shardings", {})
    if cfg not in memo:
        from repro_torch.analysis.sharded import abstract_params
        from repro_torch.convert import param_shardings

        memo[cfg] = param_shardings(cfg, mesh, abstract_params(cfg))
    return memo[cfg]


def sum_replicated_grads(grads, shardings, mesh):
    """``grads`` (this rank's, the reference's tree) with every float leaf
    whose sharding names no batch axis summed over the batch axes: one
    psum over each batch axis per dtype, of those leaves laid end to end.
    For a call inside ``batch_scope`` whose batch is split over them."""
    from repro_torch.models.common import batch_axes
    from repro_torch.runtime.elastic import spec_axes

    flat, unflatten = flatten(grads)
    shs = flatten(shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    bax = set(batch_axes(mesh))
    todo: dict = {}
    for i, (g, sh) in enumerate(zip(flat, shs)):
        if g.is_floating_point() and g.numel() and not bax & spec_axes(sh.spec):
            todo.setdefault(g.dtype, []).append(i)
    flat = list(flat)
    for idx in todo.values():
        joined = SH.psum(torch.cat([flat[i].reshape(-1) for i in idx]),
                         batch_axes(mesh), mesh)
        for i, part in zip(idx, joined.split([flat[i].numel() for i in idx])):
            flat[i] = part.view(flat[i].shape)
    return unflatten(flat)


def loss_and_grads(params, batch, cfg: ArchConfig):
    """(loss, gradients as the reference's tree) of ``lm.loss_fn``; under
    ``set_mesh``, this rank's, with the replicated leaves' batch-axis sums
    taken where the batch is split."""
    loss, grads = value_and_grad_trainable(lm.loss_fn)(params, batch, cfg)
    grads = strip_derived(grads)
    mesh = SH.get_abstract_mesh()
    if mesh is not None:
        with SH.batch_scope(batch["tokens"].shape[0]):
            if SH.batch_split(mesh):
                grads = sum_replicated_grads(grads, mesh_param_shardings(cfg, mesh),
                                             mesh)
    return loss, grads


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, microbatches: int = 1,
                    *, donate: bool = False):
    """Train step with optional gradient-accumulation microbatching:
    ``f(params, opt, batch) -> (params, opt, metrics)``.

    Gradients accumulate in the param dtype over the microbatches, as the
    reference's ``lax.scan`` does; the optimizer update runs once on the
    mean.  ``donate=True`` updates ``params`` and ``opt`` in place
    (``apply_updates``), as the reference's TrainLoop donates them.  Under
    ``core.sharding.set_mesh`` the step runs on the mesh (see the module
    docstring).
    """
    def train_step(params, opt: OptState, batch):
        mesh = SH.get_abstract_mesh()
        sh = None if mesh is None else mesh_param_shardings(cfg, mesh)
        if microbatches == 1:
            loss, grads = loss_and_grads(params, batch, cfg)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            device = flatten(params)[0][0].device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                   device=p.device),
                             strip_derived(params))
            for i in range(microbatches):
                loss_i, g_i = loss_and_grads(params, {k: v[i] for k, v in mb.items()},
                                             cfg)
                grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, g_i)
                loss = loss + loss_i
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        new, opt, metrics = apply_updates(strip_derived(params), grads, opt,
                                          opt_cfg, donate=donate, shardings=sh)
        metrics["loss"] = loss
        return carry_derived(new, params), opt, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, shape_name: str):
    """``f(params, batch) -> (last logits, caches)``: ``lm.prefill`` of
    ``batch["tokens"]`` (and ``prefix_embeds``) into caches of the shape's
    ``seq_len``; an enc-dec arch first encodes ``batch["frames"]``."""
    S = SHAPES[shape_name]["seq_len"]

    def prefill_step(params, batch):
        memory = None
        if cfg.encoder_layers:
            memory = lm.encode(params, batch["frames"], cfg)
        return lm.prefill(params, batch["tokens"], cfg, max_len=S,
                          prefix_embeds=batch.get("prefix_embeds"), memory=memory)

    return prefill_step


def make_decode_step(cfg: ArchConfig, shape_name: str):
    """``f(params, batch) -> (logits, caches)``: one ``lm.decode_step`` of
    ``batch["token"]`` against ``batch["caches"]`` (stepped in place), with
    ``batch["memory"]`` for an enc-dec arch.  ``shape_name`` is unused, as
    in the reference: the caches carry their length."""

    def decode_step(params, batch):
        return lm.decode_step(params, batch["token"], batch["caches"], cfg,
                              memory=batch.get("memory"))

    return decode_step


# ---------------------------------------------------------------------------
# fake inputs and train state (the dry run; nothing allocated)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape_name: str, mode=None) -> dict:
    """Model inputs for one (arch x shape) cell, as fake CPU tensors of
    ``mode`` with the reference's shapes and dtypes.

    train:    {tokens, labels[, prefix_embeds][, frames]}
    prefill:  same minus labels
    decode:   {token, caches[, memory]}  — one new token against seq_len
              caches (``lm.init_caches``; the enc-dec memory is
              min(S, 4096) frames)
    """
    sh = SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    d = cfg.d_model
    with lm.fake_mode(mode):
        if kind in ("train", "prefill"):
            S_text = S - cfg.modality_tokens
            out = {"tokens": torch.empty((B, S_text), dtype=torch.int32)}
            if kind == "train":
                out["labels"] = torch.empty((B, S_text), dtype=torch.int32)
            if cfg.modality_tokens:
                out["prefix_embeds"] = torch.empty((B, cfg.modality_tokens, d),
                                                   dtype=torch.bfloat16)
            if cfg.encoder_layers:
                out["frames"] = torch.empty((B, S, d), dtype=torch.bfloat16)
            return out
        out = {"token": torch.empty((B, 1), dtype=torch.int32),
               "caches": lm.init_caches(cfg, B, S)}
        if cfg.encoder_layers:
            out["memory"] = torch.empty((B, min(S, 4096), d), dtype=torch.bfloat16)
        return out


def abstract_state(cfg: ArchConfig, opt_cfg: AdamWConfig, mode=None):
    """(params, optimizer state) of a train cell on fake CPU tensors."""
    mode = lm.fake_mode(mode)
    params = lm.abstract_params(cfg, mode=mode)
    with mode:
        return params, init_opt(params, opt_cfg)


def input_spec_shardings(cfg: ArchConfig, shape_name: str) -> dict:
    """PartitionSpec tree matching input_specs."""
    kind = SHAPES[shape_name]["kind"]
    if kind in ("train", "prefill"):
        out = {"tokens": batch_spec(None)}
        if kind == "train":
            out["labels"] = batch_spec(None)
        if cfg.modality_tokens:
            out["prefix_embeds"] = batch_spec(None, None)
        if cfg.encoder_layers:
            out["frames"] = batch_spec(None, None)
        return out
    out = {"token": batch_spec(None), "caches": cache_specs(cfg)}
    if cfg.encoder_layers:
        out["memory"] = batch_spec(None, None)
    return out


# cache sharding specs (decode): KV sequence-sharded over "model",
# recurrent-state key dim over "model"


def _cache_spec_one(cfg, kind, stacked: bool):
    lead = (None,) if stacked else ()
    if kind in ("attn", "attn_local", "attn_global", "moe", "shared_attn",
                "cross_attn"):
        kv = P(*lead, BATCH_AXES, "model", None, None)  # (B, S, H, dh)
        return A.KVCache(kv, kv, P(*lead))
    if kind in ("mla_dense", "mla_moe"):
        lat = P(*lead, BATCH_AXES, "model", None)  # (B, S, dc)
        return A.MLACache(lat, lat, P(*lead))
    if kind in ("mamba", "mlstm"):
        return LA.RecurrentState(
            P(*lead, BATCH_AXES, None, "model", None),  # (B, H, dk, dv)
            P(*lead, BATCH_AXES, None, "model"),
        )
    if kind == "slstm":
        s = P(*lead, BATCH_AXES, None, "model")  # (B, H, dh)
        return LA.SLSTMState(s, s, s, s)
    raise ValueError(kind)


def cache_specs(cfg: ArchConfig):
    prefix = tuple(_cache_spec_one(cfg, k, False) for k in cfg.prefix_pattern)
    blocks = {f"b{j}": _cache_spec_one(cfg, k, True)
              for j, k in enumerate(cfg.block_pattern)}
    return lm.Caches(prefix=prefix, blocks=blocks)


def state_specs(cfg: ArchConfig, opt_cfg: AdamWConfig):
    """(param specs, optimizer-state specs) of a train state: the shardings
    of ``TrainLoop(mesh=)`` (through ``make_shardings`` +
    ``sanitize_shardings``) and of the checkpoints it writes and reads."""
    ps = lm.param_specs(cfg)
    return ps, opt_specs(ps, opt_cfg)
