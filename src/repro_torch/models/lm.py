"""LM assembly: embeddings -> (prefix blocks) -> repeated blocks -> head.

Counterpart of ``repro/models/lm.py`` for every registered arch: the
dense family (qwen, llama3.2, smollm, gemma2, llava with
``prefix_embeds``), dense or with the block-sparse FFN, the MoE family
(mixtral-8x22b; deepseek-v3 with MLA and multi-token prediction), the
hybrid zamba2-2.7b (Mamba2 blocks and one weight-shared attention + MLP
block), the recurrent xlstm-1.3b (mLSTM and sLSTM blocks) and the
encoder-decoder seamless-m4t-medium (``encode`` over stub frame
embeddings, then ``cross_attn`` decoder layers reading its output through
``memory=``).  Layer repeats keep the reference's layout, params stacked
``(NR, ...)`` per pattern entry under ``params["blocks"]["b{j}"]``; the
reference's ``lax.scan`` over them is a Python loop over the repeat index.
zamba2's ``shared_attn`` entry has no stacked params: every invocation
reads the one unstacked ``params["shared"]``, while its caches stay stacked
(one KV cache per invocation), as in the reference.

Entry points:
  init_params(gen, cfg)                   -> params
  forward(params, tokens, cfg)            -> (logits, h)
  loss_fn(params, batch, cfg)             -> scalar f32 loss
  prefill(params, tokens, cfg, max_len)   -> (last_logits, caches)
  decode_step(params, token, caches, cfg) -> (logits, caches)
  encode(params, frames, cfg)             -> encoder memory (enc-dec archs)
  init_caches(cfg, batch, max_len)        -> zero caches

Under autograd, ``forward`` rematerializes each repeat as ``cfg.remat``
says, as the reference's ``_scan_blocks`` does: ``"full"`` recomputes the
repeat in the backward pass (``torch.utils.checkpoint``), ``"dots"`` keeps
the outputs of its 2-D matrix products and recomputes the rest (the
counterpart of ``dots_with_no_batch_dims_saveable``), ``"none"`` keeps its
activations.  The encoder is not rematerialized (the reference scans it
without ``jax.checkpoint``).

``abstract_params(cfg)`` builds the ``init_params`` tree on fake tensors
(``FakeTensorMode``): shapes and dtypes, nothing allocated, for the dry
run (``launch/dryrun.py``).  ``param_specs`` and ``cache_specs`` are the
reference's PartitionSpec trees (``core.sharding.P``), entry for entry.

On a process mesh (``core.sharding.set_mesh``; ``launch.serve.Server(...,
mesh=)``) ``prefill`` / ``decode_step`` / ``forward`` take the global
tokens, identical on every rank, and each rank runs the sharded program on
its params' blocks (``runtime.elastic.make_shardings`` of
``param_specs``): the embedding is vocab-parallel (a masked gather of the
rank's rows, then a psum over "model"), the activations are the rank's
batch block (over the batch axes where they divide the batch), every
block runs its sharded program (``models/blocks.py``), and the logits are
the rank's batch block with the vocab whole (an all-gather over "model").
Caches are the rank's: its batch block, its heads (KV, recurrent states)
or the whole latent (MLA; ``attention``'s docstring says why).  ``encode``
takes the global frames and returns the rank's batch rows of the memory;
``prefill`` / ``decode_step`` take that memory (and raise on any other
row count).  ``loss_fn`` takes the global
batch too and returns the global batch's mean loss on every rank, for every
arch (an enc-dec arch's memory is the rank's rows of ``encode``); under
autograd the sharded program is differentiable (``core/sharding.py``'s
convention: a rank's gradient of a param it holds is the whole gradient of
its block, except for the params replicated over the batch axes, whose
gradients are the rank's rows' part until ``launch.steps`` sums them).
With ``cfg.remat == "full"`` each repeat's forward, its collectives
included, runs again in the backward on every rank in the same order (the
recompute does not stop early on a mesh, so it is the whole forward).

``decode_step`` steps the caches it is given in place: the attention
caches through ``attention.gqa_decode`` / ``mla_decode``, the recurrent
states by a copy of each block's new state into its stacked slot.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn, set_checkpoint_early_stop)

from repro_torch.configs.base import ArchConfig
from ..core import sharding as SH
from ..core.sharding import P
from . import attention as A
from .blocks import (_mlp_apply, block_apply, block_decode, block_init, block_spec,
                     check_kind, init_cache)
from .common import (batch_axes, batch_shard, col_apply, cross_entropy, embed_init,
                     embed_spec, map_params, model_full, model_in, normal,
                     rmsnorm, rmsnorm_init, softcap)

__all__ = [
    "init_params",
    "abstract_params",
    "param_specs",
    "cache_specs",
    "batch_axes_static",
    "fake_mode",
    "check_config",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "encode",
    "Caches",
    "init_caches",
]


def check_config(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block kind the reference does not have."""
    for kind in cfg.prefix_pattern + cfg.block_pattern:
        check_kind(kind)


def _stack_init(gen, cfg, kind, n, dtype):
    """Init n copies of a block, stacked on axis 0.  Each copy is written
    into its slot before the next is drawn (one copy is a view), so the
    stack is never held twice: a full-width MoE block is 4.8 GB (mixtral,
    bf16) to 45 GB (deepseek, f32)."""
    blk = block_init(gen, cfg, kind, dtype)
    if n == 1:
        return map_params(lambda a: a[None], blk)
    stacked = map_params(lambda a: a.new_empty((n,) + a.shape), blk)
    for r in range(n):
        if r:
            blk = block_init(gen, cfg, kind, dtype)
        map_params(lambda dst, src: dst[r].copy_(src), stacked, blk)
        blk = None
    return stacked


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16):
    """Random params from ``gen``, on ``gen``'s device."""
    check_config(cfg)
    p: dict[str, Any] = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype)}
    p["final_norm"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal(gen, (cfg.d_model, cfg.vocab), dtype,
                                    1.0 / math.sqrt(cfg.d_model))}
    for i, kind in enumerate(cfg.prefix_pattern):
        p[f"prefix{i}"] = block_init(gen, cfg, kind, dtype)
    p["blocks"] = {
        f"b{j}": _stack_init(gen, cfg, kind, cfg.n_repeats, dtype)
        for j, kind in enumerate(cfg.block_pattern)
        if kind != "shared_attn"
    }
    if "shared_attn" in cfg.block_pattern:
        p["shared"] = block_init(gen, cfg, "shared_attn", dtype)
    if cfg.encoder_layers:
        p["encoder"] = {
            "blocks": _stack_init(gen, cfg, "attn", cfg.encoder_layers, dtype),
            "norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "in_proj": {"w": normal(gen, (cfg.d_model, cfg.d_model), dtype,
                                    1.0 / math.sqrt(cfg.d_model))},
        }
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": {"w": normal(gen, (2 * cfg.d_model, cfg.d_model), dtype,
                                 1.0 / math.sqrt(2 * cfg.d_model))},
            "norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "block": block_init(gen, cfg, _mtp_kind(cfg), dtype),
        }
    return p


def fake_mode(mode=None) -> FakeTensorMode:
    """``mode``, or a new ``FakeTensorMode`` in which real constants (a
    sparse layer's numpy pattern) become fake on first use."""
    return FakeTensorMode(allow_non_fake_inputs=True) if mode is None else mode


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16, mode=None):
    """The ``init_params`` tree on fake CPU tensors of ``mode`` (a new
    ``FakeTensorMode`` by default; each leaf's ``fake_mode`` names it).
    Nothing is allocated: any arch at full width."""
    with fake_mode(mode) as mode:
        return init_params(torch.Generator().manual_seed(0), cfg, dtype)


def _add_leading(spec_tree):
    """Prepend a None axis to every PartitionSpec (stacked layer dim)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda s: P(*((None,) + tuple(s))), spec_tree,
                    is_leaf=lambda x: isinstance(x, P))


def param_specs(cfg: ArchConfig):
    """The PartitionSpec tree of ``init_params``' tree (the reference's)."""
    sp: dict[str, Any] = {"embed": embed_spec()}
    sp["final_norm"] = {"scale": P(None)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = {"w": P("data", "model")}
    for i, kind in enumerate(cfg.prefix_pattern):
        sp[f"prefix{i}"] = block_spec(cfg, kind)
    sp["blocks"] = {
        f"b{j}": _add_leading(block_spec(cfg, kind))
        for j, kind in enumerate(cfg.block_pattern)
        if kind != "shared_attn"
    }
    if "shared_attn" in cfg.block_pattern:
        sp["shared"] = block_spec(cfg, "shared_attn")
    if cfg.encoder_layers:
        sp["encoder"] = {
            "blocks": _add_leading(block_spec(cfg, "attn")),
            "norm": {"scale": P(None)},
            "in_proj": {"w": P("data", "model")},
        }
    if cfg.mtp_depth:
        sp["mtp"] = {
            "proj": {"w": P("data", "model")},
            "norm": {"scale": P(None)},
            "block": block_spec(cfg, _mtp_kind(cfg)),
        }
    return sp


def batch_axes_static():
    return ("pod", "data")


def cache_specs(cfg: ArchConfig):
    """PartitionSpecs for caches, as the reference gives them: a function
    ``spec_for(kind, stacked)`` returning ``kv(a_ndim)``, the spec of a
    cache leaf of that rank (batch over the data axes, heads over model)."""

    def spec_for(kind, stacked: bool):
        lead = (None,) if stacked else ()

        def kv(a_ndim):
            # (B, S, H, dh) or recurrent (B, H, dk, dv) / (B, H, dk)
            if a_ndim == 4:
                return P(*lead, batch_axes_static(), None, "model", None)
            if a_ndim == 3:
                return P(*lead, batch_axes_static(), None, "model")
            if a_ndim == 2:
                return P(*lead, batch_axes_static(), None)
            return P(*lead)

        return kv

    return spec_for


def _mtp_kind(cfg) -> str:
    return cfg.prefix_pattern[0] if cfg.prefix_pattern else cfg.block_pattern[0]


def _layer(tree, r: int):
    """Repeat ``r``'s params (or caches' tensors) of a stacked tree."""
    return map_params(lambda a: a[r], tree)


def _block_params(params, j: int, kind: str, r: int):
    """Pattern entry ``j``'s params in repeat ``r``: the shared block for
    ``shared_attn``, else repeat ``r`` of the stack."""
    if kind == "shared_attn":
        return params["shared"]
    return _layer(params["blocks"][f"b{j}"], r)


def _embed(params, tokens, cfg):
    """Token embeddings; on a mesh, of this rank's batch block, gathered
    from this rank's vocab rows (masked) and summed over "model"."""
    emb = params["embed"]["emb"]
    tokens = batch_shard(tokens)
    if emb.shape[0] < cfg.vocab:  # vocab-parallel: a masked local gather
        t = tokens.long() - SH.axis_index("model") * emb.shape[0]
        inside = (t >= 0) & (t < emb.shape[0])
        h = emb[torch.clamp(t, 0, emb.shape[0] - 1)]
        h = torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype,
                                                          device=h.device))
        h = SH.psum(h, "model")
    else:
        h = emb[tokens.long()]
    if cfg.gemma_norm:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def head_stationary(rows: int, batch: int, S: int, d: int, d_l: int, v_l: int) -> bool:
    """Whether an untied head whose d is split over "data" keeps its weight
    in place: all-gather the activations over "data" (``batch`` rows of
    ``S`` x d), multiply by the rank's (d_l, v_l) block, psum-scatter the
    partial logits back to the rank's ``rows``; rather than all-gather the
    weight (d x v_l, FSDP).  The one that moves fewer elements; a decode
    step's head (deepseek's 7,168 x 64,640 block) is weight-bound."""
    return d * v_l > batch * S * d + rows * S * v_l and d_l < d


def _logits(params, h, cfg):
    """Logits over the whole vocab; on a mesh, this rank's vocab block of
    them all-gathered over "model"."""
    if cfg.tie_embeddings:
        emb = params["embed"]["emb"]
        logits = torch.matmul(model_in(h, emb.shape[0] < cfg.vocab), emb.T)
    else:
        w = params["lm_head"]["w"]
        batch = h.shape[0] * (SH.axis_size("data") if SH.get_abstract_mesh()
                              is not None and SH.batch_split() else 1)
        if head_stationary(h.shape[0], batch, h.shape[1], cfg.d_model, w.shape[0],
                           w.shape[1]):
            split = batch > h.shape[0]
            hs = SH.gather_dim(h, "data", 0) if split else h
            hs = model_in(SH.slice_dim(hs, "data", hs.ndim - 1), w.shape[1] < cfg.vocab)
            part = torch.matmul(hs, w)
            coll = SH.collectives()
            logits = coll.psum_scatter(part, "data") if split \
                else coll.psum(part, "data")
        else:
            logits = col_apply(params["lm_head"], h, cfg.vocab)
    return model_full(softcap(logits, cfg.logit_softcap), cfg.vocab)


def _with_prefix(params, tokens, cfg, prefix_embeds):
    h = _embed(params, tokens, cfg)
    if prefix_embeds is not None:
        h = torch.cat([batch_shard(prefix_embeds).to(h.dtype), h], dim=1)
    return h


def _scoped(fn):
    """Run a model entry point inside ``core.sharding.batch_scope`` of its
    tokens' global batch where a mesh is set (the blocks read it)."""
    import functools

    @functools.wraps(fn)
    def wrapped(params, tokens, *args, **kwargs):
        if SH.get_abstract_mesh() is None:
            return fn(params, tokens, *args, **kwargs)
        with SH.batch_scope(tokens.shape[0]):
            return fn(params, tokens, *args, **kwargs)

    return wrapped


def _unstacked(stack, n: int) -> list:
    """The ``n`` layers of a stacked tree, each tensor a view of the
    stacked one.  ``unbind`` makes one backward node per stacked tensor, so
    the layers' gradients are stacked once instead of each scattered into
    a zero tensor of the whole stack."""
    parts = map_params(lambda a: a.unbind(0), stack)
    return [map_params(lambda a: a[r], parts) for r in range(n)]


def _repeats(params, cfg) -> list:
    """Each repeat's params (zamba2's shared block in every repeat)."""
    shared = {f"b{j}": params["shared"] for j, kind in enumerate(cfg.block_pattern)
              if kind == "shared_attn"}
    return [dict(layer, **shared)
            for layer in _unstacked(params["blocks"], cfg.n_repeats)]


# the outputs remat="dots" keeps: 2-D matrix products (``torch.matmul`` of
# (B, S, d) by (d, e) folds into one ``mm``), as JAX's
# ``dots_with_no_batch_dims_saveable`` keeps dot_generals without batch
# dimensions; batched products (``bmm``: attention scores, the GLA chunks'
# einsums, the MoE experts) and everything else are recomputed.  The block
# kernel runs through ctypes inside an autograd.Function, out of the
# dispatcher's sight: its forward is recomputed too.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _repeat(h, layer, cfg, memory=None):
    for j, kind in enumerate(cfg.block_pattern):
        h, _ = block_apply(layer[f"b{j}"], h, cfg, kind, memory=memory)
    return h


@_scoped
def forward(params, tokens, cfg: ArchConfig, *, prefix_embeds=None, memory=None):
    """tokens: (B, S_text) int; prefix_embeds: (B, S_mod, d) modality stub;
    memory: (B, S_enc, d) encoder output (enc-dec archs).
    Returns (logits (B, S, vocab), h (B, S, d)).  While autograd records,
    each repeat is rematerialized as ``cfg.remat`` says."""
    check_config(cfg)
    memory = _memory_rows(memory, tokens.shape[0])
    h = _with_prefix(params, tokens, cfg, prefix_embeds)
    for i, kind in enumerate(cfg.prefix_pattern):
        h, _ = block_apply(params[f"prefix{i}"], h, cfg, kind, memory=memory)
    remat = torch.is_grad_enabled() and cfg.remat != "none"
    # any other policy than "none" / "dots" is "full", as in the reference
    context_fn = _dots_context if cfg.remat == "dots" else noop_context_fn
    # on a mesh every rank recomputes a repeat whole (collectives included)
    whole = SH.get_abstract_mesh() is not None
    for layer in _repeats(params, cfg):
        if remat:  # the blocks draw no random numbers: no RNG state to keep
            with set_checkpoint_early_stop(not whole):
                h = checkpoint(SH.in_this_scope(_repeat), h, layer, cfg, memory,
                               use_reentrant=False,
                               preserve_rng_state=False, context_fn=context_fn)
        else:
            h = _repeat(h, layer, cfg, memory)
    h = rmsnorm(params["final_norm"], h, gemma_style=cfg.gemma_norm)
    return _logits(params, h, cfg), h


@_scoped
def encode(params, frames, cfg: ArchConfig):
    """Encoder for enc-dec archs. frames: (B, S_enc, d) stub embeddings.

    ``in_proj``, then ``cfg.encoder_layers`` pre-LN blocks of non-causal
    GQA (with RoPE) and the FFN (block-sparse when ``cfg.ffn_density < 1``),
    then the final norm.  The dtype follows ``jnp``'s promotion: f32 frames
    over bf16 params give an f32 encoder and f32 memory, bf16 frames a bf16
    one.  On a mesh the rank encodes its batch rows of the global
    ``frames``: the column-parallel ``in_proj`` (its output gathered over
    "model"), then the blocks' sharded programs; it returns its rows.
    Under autograd the gather's transpose is the rank's slice and
    ``in_proj``'s FSDP gather's a psum-scatter over the batch axes; the
    frames take no gradient."""
    enc = params["encoder"]
    d = cfg.d_model
    h = model_full(col_apply(enc["in_proj"], batch_shard(frames), d), d)
    for bp in _unstacked(enc["blocks"], cfg.encoder_layers):
        a, _ = A.gqa_apply(bp["attn"], rmsnorm(bp["ln1"], h), cfg, causal=False)
        h = h + a
        h = h + _mlp_apply(bp["mlp"], rmsnorm(bp["ln2"], h), cfg)
    return rmsnorm(enc["norm"], h)


def loss_fn(params, batch, cfg: ArchConfig):
    """batch: dict(tokens, labels[, prefix_embeds, frames]).  Next-token
    cross-entropy over the text positions (the modality prefix dropped), in
    f32; with ``cfg.mtp_depth`` plus 0.3 times the multi-token prediction
    loss.  Enc-dec archs encode ``frames`` first.  On a mesh the batch is
    the global one (every rank's the same) and the loss its mean."""
    if SH.get_abstract_mesh() is None:
        return _loss(params, batch, cfg)
    check_config(cfg)
    with SH.batch_scope(batch["tokens"].shape[0]):
        return _loss(params, batch, cfg)


def _loss(params, batch, cfg):
    memory = None
    if cfg.encoder_layers:
        memory = encode(params, batch["frames"], cfg)
    logits, h = forward(params, batch["tokens"], cfg,
                        prefix_embeds=batch.get("prefix_embeds"), memory=memory)
    S_text = batch["tokens"].shape[1]
    logits_text = logits[:, -S_text:]  # drop modality prefix positions
    labels = batch_shard(batch["labels"])
    loss = cross_entropy(logits_text[:, :-1], labels[:, 1:])
    if cfg.mtp_depth:
        loss = loss + 0.3 * _mtp_loss(params, h[:, -S_text:], batch, cfg)
    return loss


def _mtp_loss(params, h, batch, cfg):
    """DeepSeek-V3 multi-token prediction (depth 1): predict t+2 from the
    main trunk state at t combined with the embedding of token t+1.

    Runs at the full sequence length (the token t+1 stream padded with a
    zero at the end) so the MTP block takes the same attention path as the
    trunk; the ragged tail is masked out of the loss.
    """
    mtp = params["mtp"]
    tokens = batch["tokens"]
    next_tokens = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    emb_next = _embed(params, next_tokens, cfg)  # (B, S, d)
    x = torch.cat([rmsnorm(mtp["norm"], h), emb_next], dim=-1)
    x = model_full(col_apply(mtp["proj"], x, cfg.d_model), cfg.d_model)
    x, _ = block_apply(mtp["block"], x, cfg, _mtp_kind(cfg))
    logits = _logits(params, x, cfg)  # position t predicts token t+2
    S = tokens.shape[1]
    mask = (torch.arange(S, device=tokens.device) < S - 2).float()[None, :]
    labels = batch_shard(batch["labels"])
    labels_t2 = torch.cat([labels[:, 2:], torch.zeros_like(labels[:, :2])], dim=1)
    return cross_entropy(logits, labels_t2, mask=mask.expand(labels_t2.shape))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


class Caches(NamedTuple):
    prefix: tuple  # per prefix block
    blocks: dict  # {f"b{j}": a cache of stacked (NR, ...) tensors}
    mtp: Any = None


def _has_length(cache) -> bool:
    """A KVCache / MLACache (a length beside its tensors), not a recurrent
    state (``RecurrentState`` / ``SLSTMState``: tensors only)."""
    return "length" in cache._fields


def _map_cache(fn, *caches):
    """A cache whose tensors are ``fn`` of the caches' tensors (a KVCache's
    or MLACache's length kept from the first)."""
    first = caches[0]
    if not _has_length(first):
        return type(first)(*(fn(*ts) for ts in zip(*caches)))
    tensors = zip(*(c[:-1] for c in caches))
    return type(first)(*(fn(*ts) for ts in tensors), first.length)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None):
    check_config(cfg)
    prefix = tuple(init_cache(cfg, kind, batch, max_len, dtype, device)
                   for kind in cfg.prefix_pattern)

    def stack(kind):
        NR = cfg.n_repeats
        return _map_cache(lambda a: a.expand((NR,) + a.shape).clone(),
                          init_cache(cfg, kind, batch, max_len, dtype, device))

    blocks = {f"b{j}": stack(kind) for j, kind in enumerate(cfg.block_pattern)}
    return Caches(prefix=prefix, blocks=blocks)


def _grow_cache(c, cfg, kind, max_len: int):
    """Embed a prefill cache (length S) into max_len-capacity buffers; a
    recurrent state is O(1) and returned as it is."""
    if not _has_length(c):
        return c
    if isinstance(c, A.MLACache):
        S = c.ckv.shape[1]
        if S >= max_len:
            return c
        pad = (0, 0, 0, max_len - S)  # (feature, sequence)
        return _map_cache(lambda a: torch.nn.functional.pad(a, pad), c)
    S = c.k.shape[1]
    window = None
    if kind == "attn_local" or (kind in ("attn", "moe") and cfg.sliding_window):
        window = cfg.sliding_window
    cap = min(max_len, window) if window else max_len
    if S >= cap:
        return A.KVCache(c.k[:, -cap:], c.v[:, -cap:], c.length)
    pad = (0, 0, 0, 0, 0, cap - S)  # (dh, heads, sequence)
    return _map_cache(lambda a: torch.nn.functional.pad(a, pad), c)


def _stack_caches(caches: list):
    return _map_cache(lambda *ts: torch.stack(ts), *caches)


def _memory_rows(memory, B: int):
    """``memory`` checked: on a mesh it is ``encode``'s output, the rank's
    rows of the global batch B."""
    mesh = SH.get_abstract_mesh()
    if memory is None or mesh is None:
        return memory
    rows = B // SH.axis_size(batch_axes(mesh), mesh) if SH.batch_split(mesh) else B
    if memory.shape[0] != rows:
        raise ValueError(f"on a mesh the encoder memory holds the rank's {rows} "
                         f"rows of the batch of {B} (lm.encode's output); got "
                         f"{memory.shape[0]}")
    return memory


@_scoped
def prefill(params, tokens, cfg: ArchConfig, max_len: int, *, prefix_embeds=None,
            memory=None):
    """Run the full prompt, materializing decode caches at max_len capacity.

    Returns (last_token_logits, Caches).  The prefill KV (prompt length S)
    is written into the front of the max_len cache buffers.  ``memory`` is
    the encoder's output (enc-dec archs).
    """
    check_config(cfg)
    memory = _memory_rows(memory, tokens.shape[0])
    h = _with_prefix(params, tokens, cfg, prefix_embeds)
    prefix_caches = []
    for i, kind in enumerate(cfg.prefix_pattern):
        h, c = block_apply(params[f"prefix{i}"], h, cfg, kind, memory=memory)
        prefix_caches.append(_grow_cache(c, cfg, kind, max_len))
    per_layer = {f"b{j}": [] for j in range(len(cfg.block_pattern))}
    for r in range(cfg.n_repeats):
        for j, kind in enumerate(cfg.block_pattern):
            h, c = block_apply(_block_params(params, j, kind, r), h, cfg, kind,
                               memory=memory)
            per_layer[f"b{j}"].append(_grow_cache(c, cfg, kind, max_len))
    h = rmsnorm(params["final_norm"], h, gemma_style=cfg.gemma_norm)
    logits = _logits(params, h[:, -1:], cfg)
    blocks = {key: _stack_caches(cs) for key, cs in per_layer.items()}
    return logits[:, 0], Caches(prefix=tuple(prefix_caches), blocks=blocks)


@_scoped
def decode_step(params, token, caches: Caches, cfg: ArchConfig, *, memory=None):
    """token: (B, 1) int -> (logits (B, vocab), caches stepped in place).

    Attention caches are written in place by their decode and gain one in
    ``length``; a recurrent block's new state is copied into its stacked
    slot (a state has no length).  ``memory`` is the encoder's output
    (enc-dec archs), read again by every cross_attn layer at every step."""
    check_config(cfg)
    memory = _memory_rows(memory, token.shape[0])
    h = _embed(params, token, cfg)
    new_prefix = []
    for i, kind in enumerate(cfg.prefix_pattern):
        h, c = block_decode(params[f"prefix{i}"], h, caches.prefix[i], cfg, kind,
                            memory=memory)
        new_prefix.append(c)
    for r in range(cfg.n_repeats):
        for j, kind in enumerate(cfg.block_pattern):
            c = caches.blocks[f"b{j}"]
            h, new = block_decode(_block_params(params, j, kind, r), h,
                                  _map_cache(lambda a: a[r], c), cfg, kind,
                                  memory=memory)
            if not _has_length(c):
                for dst, src in zip(c, new):
                    dst[r].copy_(src)
    blocks = {key: c._replace(length=c.length + 1) if _has_length(c) else c
              for key, c in caches.blocks.items()}
    h = rmsnorm(params["final_norm"], h, gemma_style=cfg.gemma_norm)
    logits = _logits(params, h, cfg)
    return logits[:, 0], Caches(prefix=tuple(new_prefix), blocks=blocks)
