"""Closed forms of the sharded LM program on a (data, model) process mesh.

What one rank of ``models/lm.py``'s sharded program (``Server(...,
mesh=)``) holds and moves, from the spec trees and the config alone:

* :func:`param_bytes`: the bytes of its blocks of the params
  (``lm.param_specs`` through ``make_shardings`` / ``sanitize_shardings``);
* :func:`forward_collectives`, :func:`serve_collectives`,
  :func:`moe_collectives`: the calls and bytes, by kind, of the collectives
  of a forward pass over (B, S) tokens, of a prefill plus decode steps, and
  of one MoE layer, counted as ``core/collectives.py`` counts them (the
  bytes of each call's result on the rank; a collective over one rank
  counts nothing);
* :func:`block_kernel_launches`: its launches of the block kernel.

Each term follows the code path it counts (``models/common.py``,
``attention.py``, ``moe.py``, ``sparse/layers.py``, ``lm.py``); the CPU
tests hold them against a 4-rank world and ``chip_smoke.py`` against the
ranks on the card.  Prefill lengths below the chunked-attention threshold
only (MLA's chunked path gathers its up-projections once per chunk).
"""
from __future__ import annotations

from collections import Counter

import torch

from ..core.collectives import KINDS
from ..core.mesh import dry_process_mesh
from ..sparse.layers import blocks_per_row

__all__ = ["param_bytes", "forward_collectives", "serve_collectives",
           "moe_collectives", "block_kernel_launches"]

AXES = ("data", "model")


def _split(n: int, ranks: int) -> bool:
    """Whether a dim of ``n`` is split over an axis of ``ranks`` (the
    sanitized spec keeps the entry)."""
    return ranks > 1 and n % ranks == 0


def _local(n: int, ranks: int) -> int:
    return n // ranks if _split(n, ranks) else n


def param_bytes(cfg, shape, dtype=torch.bfloat16) -> int:
    """Bytes of one rank's blocks of ``init_params(cfg, dtype)`` on a
    (data, model) mesh of ``shape``: every leaf's shard shape (sanitized
    specs) times its element size (the routers are float32, the block
    indices int32).  The same on every rank."""
    from ..models import lm
    from ..runtime.elastic import make_shardings, sanitize_shardings
    from ..tree import leaves

    mesh = dry_process_mesh(shape, AXES)
    params = abstract_params(cfg, dtype)
    sh = sanitize_shardings(make_shardings(mesh, lm.param_specs(cfg)), params)
    total = 0
    for t, s in zip(leaves(params), leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))):
        n = 1
        for k in s.shard_shape(t.shape):
            n *= k
        total += n * t.element_size()
    return total


def abstract_params(cfg, dtype=torch.bfloat16) -> dict:
    """The reference's param tree of ``cfg`` on fake tensors: ``lm.
    abstract_params``, whose block-sparse FFN layers (their row pointers
    are data-dependent, which a fake init cannot build) are laid out from
    the dense tree's shapes: ``browind`` / ``bcolind`` (nb,) int32 and
    ``bvalues`` (nb, r, c) per projection, stacked where the layer is."""
    import dataclasses

    from ..models import lm

    if cfg.ffn_density >= 1.0:
        return lm.abstract_params(cfg, dtype)
    mode = lm.fake_mode()
    dense = lm.abstract_params(dataclasses.replace(cfg, ffn_density=1.0), dtype,
                               mode=mode)
    r, c = cfg.sparse_block

    def sparse(w):
        lead, (d_in, d_out) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
        nb = (d_out // r) * blocks_per_row(d_in // c, cfg.ffn_density)
        with mode:
            return {"browind": torch.empty(lead + (nb,), dtype=torch.int32),
                    "bcolind": torch.empty(lead + (nb,), dtype=torch.int32),
                    "bvalues": torch.empty(lead + (nb, r, c), dtype=dtype)}

    def walk(t):
        if not isinstance(t, dict):
            return t
        if "mlp" in t and "w_gate" in t["mlp"]:
            t = dict(t, mlp={k: sparse(v["w"]) for k, v in t["mlp"].items()})
        return {k: walk(v) if k != "mlp" else v for k, v in t.items()}

    return walk(dense)


class _Tally:
    def __init__(self):
        self.calls, self.bytes = Counter(), Counter()

    def add(self, kind: str, nbytes: int, n: int = 1) -> None:
        self.calls[kind] += n
        self.bytes[kind] += n * int(nbytes)

    def add_all(self, other: "_Tally", times: int = 1) -> None:
        for k in KINDS:
            self.calls[k] += times * other.calls[k]
            self.bytes[k] += times * other.bytes[k]

    def out(self) -> dict:
        return {"calls": {k: self.calls[k] for k in KINDS},
                "bytes": {k: self.bytes[k] for k in KINDS}}


def _col(t: _Tally, d_in: int, d_out: int, Dd: int, Dm: int, e: int) -> None:
    """A column-parallel weight (d_in over data, d_out over model): its
    FSDP all-gather."""
    if _split(d_in, Dd):
        t.add("all-gather", d_in * _local(d_out, Dm) * e)


def _row(t: _Tally, d_in: int, d_out: int, tokens: int, Dd: int, Dm: int,
         e: int) -> None:
    """A row-parallel weight (d_in over model, d_out over data): its FSDP
    all-gather and the psum of the partial products."""
    if _split(d_out, Dd):
        t.add("all-gather", _local(d_in, Dm) * d_out * e)
    if _split(d_in, Dm):
        t.add("all-reduce", tokens * d_out * e)


def _swiglu(t, d, f, tokens, Dd, Dm, e) -> None:
    _col(t, d, f, Dd, Dm, e)
    _col(t, d, f, Dd, Dm, e)
    _row(t, f, d, tokens, Dd, Dm, e)


def _sparse_ffn(t, cfg, tokens, Dm, e) -> None:
    """The gate's and up's rows (one pattern: one layout) all-gathered once
    as their product, or each summed; then the down-projection's."""
    r, c = cfg.sparse_block
    d, f = cfg.d_model, cfg.d_ff
    for d_in, d_out, runs in ((d, f, 2), (f, d, 1)):
        per_row = blocks_per_row(d_in // c, cfg.ffn_density)
        nb = (d_out // r) * per_row
        if not _split(nb, Dm):
            continue
        if (nb // Dm) % per_row == 0:  # whole block-rows: rows gathered
            t.add("all-gather", d_out * tokens * e)
        else:  # runs end inside block-rows: summed in the accumulation dtype
            t.add("all-reduce", d_out * tokens * 4, runs)


def _mlp(t, cfg, tokens, Dd, Dm, e) -> None:
    if cfg.ffn_density < 1.0:
        _sparse_ffn(t, cfg, tokens, Dm, e)
    else:
        _swiglu(t, cfg.d_model, cfg.d_ff, tokens, Dd, Dm, e)


def _gqa(t, cfg, tokens, Dd, Dm, e) -> None:
    d, dh, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    widths = (H * dh, KV * dh, KV * dh)
    for n in widths:
        _col(t, d, n, Dd, Dm, e)
    local = Dm > 1 and H % Dm == 0 and KV % Dm == 0 \
        and all(_split(n, Dm) for n in widths)
    if not local:
        for n in widths:
            if _split(n, Dm):
                t.add("all-gather", tokens * n * e)
    _row(t, H * dh, d, tokens, Dd, Dm, e)


def _mla(t, cfg, tokens, Dd, Dm, e) -> None:
    d, H, dh, dr = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.mla_rope_dim
    dc, dq = cfg.mla_kv_comp, cfg.mla_q_comp
    _col(t, d, dq, Dd, Dm, e)
    if _split(dq, Dm):
        t.add("all-gather", tokens * dq * e)  # cq whole
    _col(t, dq, H * dh, Dd, Dm, e)
    _col(t, dq, H * dr, Dd, Dm, e)
    local = Dm > 1 and H % Dm == 0 and _split(H * dh, Dm) and _split(H * dr, Dm)
    if not local:
        for n in (H * dh, H * dr):
            if _split(n, Dm):
                t.add("all-gather", tokens * n * e)
    _col(t, d, dc, Dd, Dm, e)
    if _split(dc, Dm):
        t.add("all-gather", tokens * dc * e)  # ckv whole
    for _ in ("w_uk", "w_uv"):  # up-projections, in the attention
        _col(t, dc, H * dh, Dd, Dm, e)
        if not local and _split(H * dh, Dm):
            t.add("all-gather", dc * H * dh * e)
    _row(t, H * dh, d, tokens, Dd, Dm, e)


def _moe(t, cfg, B: int, S: int, Dd, Dm, e) -> None:
    """One MoE layer over the global batch (B, S)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    T = B * S
    G = Dd if Dd > 1 else 1
    if T % G or T // G < 8:
        G = 1
    T_loc = T // G
    cap = cfg.moe_capacity(T_loc)
    split = _split(B, Dd)
    if G == 1 and split:
        t.add("all-gather", T * d * e)  # every token into the one group
    if E >= 64:
        E_l, d_l = _local(E, Dd), _local(d, Dm)
        if E_l < E and G > 1:
            t.add("all-to-all", E * cap * d_l * e)
        Gx = Dd if (E_l < E and G > 1) else 1
        if d_l < d:
            t.add("all-reduce", E_l * Gx * cap * f * e, 2)  # h and u
        if E_l < E:  # back: an all-to-all, or all-gather of the experts
            t.add("all-to-all" if G > 1 else "all-gather", E * cap * d_l * e)
        if d_l < d:
            t.add("all-gather", T_loc * d * e)
    else:
        f_l = _local(f, Dm)
        if _split(d, Dd):
            t.add("all-gather", E * d * f_l * e, 2)  # w_gate, w_up
            t.add("all-gather", E * f_l * d * e)  # w_down
        if f_l < f:
            t.add("all-reduce", E * cap * d * e)
    if cfg.n_shared_experts:
        _swiglu(t, d, f * cfg.n_shared_experts, T_loc, Dd, Dm, e)
    if G > 1 and not split:
        t.add("all-gather", T * d * e)  # every group's tokens


def _block(t, cfg, kind, B, S, Dd, Dm, e) -> None:
    tokens = (B // Dd if _split(B, Dd) else B) * S
    if kind in ("mla_dense", "mla_moe"):
        _mla(t, cfg, tokens, Dd, Dm, e)
    else:
        _gqa(t, cfg, tokens, Dd, Dm, e)
    if kind in ("moe", "mla_moe"):
        _moe(t, cfg, B, S, Dd, Dm, e)
    else:
        _mlp(t, cfg, tokens, Dd, Dm, e)


def forward_collectives(cfg, shape, B: int, S: int, itemsize: int) -> _Tally:
    """A forward pass (prefill of S tokens, or a decode step at S = 1)
    over the global batch B: the embedding's psum, every block's, and the
    last position's logits gathered over "model"."""
    Dd, Dm = shape
    t = _Tally()
    Bl = B // Dd if _split(B, Dd) else B
    d, V, e = cfg.d_model, cfg.vocab, itemsize
    if _split(V, Dm):
        t.add("all-reduce", Bl * S * d * e)
    for kind in cfg.prefix_pattern:
        _block(t, cfg, kind, B, S, Dd, Dm, e)
    for _ in range(cfg.n_repeats):
        for kind in cfg.block_pattern:
            _block(t, cfg, kind, B, S, Dd, Dm, e)
    if not cfg.tie_embeddings:
        from ..models.lm import head_stationary

        v_l = _local(V, Dm)
        if head_stationary(Bl, B, 1, d, _local(d, Dd), v_l):
            if Bl < B:
                t.add("all-gather", B * d * e)
                t.add("reduce-scatter", Bl * v_l * e)
            else:
                t.add("all-reduce", B * v_l * e)
        else:
            _col(t, d, V, Dd, Dm, e)
    if _split(V, Dm):
        t.add("all-gather", Bl * V * e)
    return t


def serve_collectives(cfg, shape, B: int, S: int, steps: int,
                      itemsize: int) -> dict:
    """``{"calls", "bytes"}`` by kind of a prefill of (B, S) and ``steps``
    decode steps (``lm.prefill`` / ``lm.decode_step``; ``Server.generate``
    adds one all-gather of (B, 1) int32 tokens per token where the batch
    is split over "data")."""
    t = forward_collectives(cfg, shape, B, S, itemsize)
    t.add_all(forward_collectives(cfg, shape, B, 1, itemsize), steps)
    return t.out()


def moe_collectives(cfg, shape, B: int, S: int, itemsize: int) -> dict:
    """``{"calls", "bytes"}`` by kind of one ``moe_apply`` over (B, S)."""
    t = _Tally()
    _moe(t, cfg, B, S, shape[0], shape[1], itemsize)
    return t.out()


def block_kernel_launches(cfg, forwards: int) -> int:
    """A rank's block-kernel launches over ``forwards`` forward passes:
    one per sparse projection of each dense-FFN block it runs (prefix and
    repeats; the MTP block is not on the serving path)."""
    if cfg.ffn_density >= 1.0:
        return 0
    kinds = list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.n_repeats
    dense = sum(1 for k in kinds if k not in ("moe", "mla_moe"))
    return 3 * dense * forwards
