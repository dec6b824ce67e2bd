"""Closed forms of the sharded LM program on a (data, model) process mesh.

What one rank of ``models/lm.py``'s sharded program (``Server(...,
mesh=)``) holds and moves, from the spec trees and the config alone:

* :func:`param_bytes`: the bytes of its blocks of the params
  (``lm.param_specs`` through ``make_shardings`` / ``sanitize_shardings``);
* :func:`forward_collectives`, :func:`serve_collectives`,
  :func:`encode_collectives`, :func:`moe_collectives`: the calls and
  bytes, by kind, of the collectives of a forward pass over (B, S) tokens,
  of a prefill plus decode steps, of one encoder pass, and of one MoE
  layer, counted as ``core/collectives.py`` counts them (the bytes of each
  call's result on the rank; a collective over one rank counts nothing);
* :func:`train_collectives`: the calls and bytes, by kind, of one train
  step (``launch.steps.make_train_step`` on the mesh) of any arch: the
  encoder's pass, the forward's, the recompute's, the backward's
  transposes and ``model_in`` sums (``core/sharding.py``'s convention),
  the gradient sums of the params replicated over "data", and the clip's
  psum;
* :func:`block_kernel_launches`, :func:`encode_block_kernel_launches` and
  :func:`train_block_kernel_launches`: its launches of the block kernel.

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
           "encode_collectives", "moe_collectives", "train_collectives",
           "block_kernel_launches", "encode_block_kernel_launches",
           "train_block_kernel_launches"]

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
    """Calls and bytes by kind.  A forward's collective is added with its
    transpose (``back``: (kind, bytes) pairs, or None where the transpose
    moves nothing); :meth:`grad` adds a collective of the backward alone
    (``model_in``'s psum).  A serving tally counts the forwards only."""

    def __init__(self, train: bool = False):
        self.calls, self.bytes = Counter(), Counter()
        self.train = train

    def add(self, kind: str, nbytes: int, n: int = 1, back=None) -> None:
        self.calls[kind] += n
        self.bytes[kind] += n * int(nbytes)
        if self.train and back is not None:
            self.grad(*back, n=n)

    def grad(self, kind: str, nbytes: int, n: int = 1) -> None:
        if self.train:
            self.calls[kind] += n
            self.bytes[kind] += n * int(nbytes)

    def add_all(self, other: "_Tally", times: int = 1) -> None:
        for k in KINDS:
            self.calls[k] += times * other.calls[k]
            self.bytes[k] += times * other.bytes[k]

    def out(self) -> dict:
        return {"calls": {k: self.calls[k] for k in KINDS},
                "bytes": {k: self.bytes[k] for k in KINDS}}


class _Ctx:
    """The mesh extents, the element size and whether the batch of the call
    is split over "data" (which decides the batch-axis transposes)."""

    def __init__(self, t: _Tally, Dd: int, Dm: int, e: int, B: int):
        self.t, self.Dd, self.Dm, self.e = t, Dd, Dm, e
        self.bs = _split(B, Dd)

    def data_gather(self, full_bytes: int) -> None:
        """An all-gather over "data" of ``full_bytes`` gathered: its
        transpose a reduce-scatter where the batch is split, a slice
        otherwise."""
        self.t.add("all-gather", full_bytes,
                   back=("reduce-scatter", full_bytes // self.Dd) if self.bs else None)

    def model_in(self, nbytes: int) -> None:
        """``model_in``: a psum over "model" of the gradient."""
        self.t.grad("all-reduce", nbytes)


def _col(c: _Ctx, d_in: int, d_out: int) -> None:
    """A column-parallel weight (d_in over data, d_out over model): its
    FSDP all-gather."""
    if _split(d_in, c.Dd):
        c.data_gather(d_in * _local(d_out, c.Dm) * c.e)


def _row(c: _Ctx, d_in: int, d_out: int, tokens: int, whole_in: bool = False) -> None:
    """A row-parallel weight (d_in over model, d_out over data): its FSDP
    all-gather and the psum of the partial products; ``whole_in``: x holds
    every feature and is sliced to the rank's block (its gradient
    all-gathered)."""
    if _split(d_out, c.Dd):
        c.data_gather(_local(d_in, c.Dm) * d_out * c.e)
    if _split(d_in, c.Dm):
        if whole_in:
            c.t.grad("all-gather", tokens * d_in * c.e)
        c.t.add("all-reduce", tokens * d_out * c.e)


def _swiglu(c: _Ctx, d, f, tokens, varied: bool = False) -> None:
    _col(c, d, f)
    _col(c, d, f)
    if _split(f, c.Dm) and not varied:
        c.model_in(tokens * d * c.e)
    _row(c, f, d, tokens)


def _sparse_ffn(c: _Ctx, cfg, tokens) -> None:
    """The gate's and up's rows (one pattern: one layout) all-gathered once
    as their product, or each summed; then the down-projection's.  Each
    run's input enters through ``model_in``."""
    r, cc = cfg.sparse_block
    d, f = cfg.d_model, cfg.d_ff
    for d_in, d_out, runs in ((d, f, 2), (f, d, 1)):
        per_row = blocks_per_row(d_in // cc, cfg.ffn_density)
        nb = (d_out // r) * per_row
        if not _split(nb, c.Dm):
            continue
        c.model_in(tokens * d_in * c.e)
        if (nb // c.Dm) % per_row == 0:  # whole block-rows: rows gathered
            c.t.add("all-gather", d_out * tokens * c.e)
        else:  # runs end inside block-rows: summed in the accumulation dtype
            c.t.add("all-reduce", d_out * tokens * 4, runs)


def _mlp(c: _Ctx, cfg, tokens) -> None:
    if cfg.ffn_density < 1.0:
        _sparse_ffn(c, cfg, tokens)
    else:
        _swiglu(c, cfg.d_model, cfg.d_ff, tokens)


def _gqa(c: _Ctx, cfg, tokens, kv_tokens=None) -> None:
    """GQA; cross-attention where k and v come from ``kv_tokens`` of the
    memory (on a mesh, the rank's rows of it; the memory enters every
    layer's k and v through one ``model_in``, which :func:`_train_pass`
    counts)."""
    d, dh, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    Dm, e = c.Dm, c.e
    cross = kv_tokens is not None
    kv_tokens = tokens if kv_tokens is None else kv_tokens
    widths = (H * dh, KV * dh, KV * dh)
    for n in widths:
        _col(c, d, n)
    if any(_split(n, Dm) for n in (widths[:1] if cross else widths)):
        c.model_in(tokens * d * e)
    local = Dm > 1 and H % Dm == 0 and KV % Dm == 0 \
        and all(_split(n, Dm) for n in widths)
    if not local:
        for n, t in zip(widths, (tokens, kv_tokens, kv_tokens)):
            if _split(n, Dm):
                c.t.add("all-gather", t * n * e)
    _row(c, H * dh, d, tokens, whole_in=not local)


def _heads_split(c: _Ctx, heads: int) -> bool:
    """Whether a recurrent block's heads are the rank's (its sharded
    program raises where "model" does not divide them)."""
    if c.Dm > 1 and heads % c.Dm:
        raise NotImplementedError(f"{heads} heads over {c.Dm} ranks of 'model'")
    return c.Dm > 1


def _recurrent(c: _Ctx, cfg, kind, tokens) -> None:
    """A Mamba2, mLSTM or sLSTM block: its column-parallel projections'
    FSDP gathers (Mamba2's ``in_proj`` output then an all-to-all over
    "model" of ``d_inner`` features a token: x's and z's blocks of the
    rank's heads, in n slots), the norm's psum of an f32 partial sum of
    squares a token, and the row-parallel ``out_proj``.  In the backward
    the sum of squares' gradient is summed over "model" (it enters the
    rank's features through ``model_in``), and the leaves replicated over
    "model" that the rank slices to its heads (Mamba2's f32 ``a_log`` and
    ``d_skip``, every norm's scale) have their slices' gradients
    all-gathered (``core/sharding.py``: a slice's transpose)."""
    d, e = cfg.d_model, c.e
    if kind == "mamba":
        H, di, N = cfg.ssm_heads, cfg.ssm_d_inner, cfg.ssm_state
        cols = (2 * di, 2 * N * H, H)
        sliced = (H * 4, H * 4, di * e)  # a_log, d_skip, norm.scale
    else:
        H = cfg.n_heads
        di = d
        cols = (d, d, d, H, H) if kind == "mlstm" else (4 * d,)
        sliced = (d * e,)  # norm.scale
    split = _heads_split(c, H)
    for n in cols:
        _col(c, d, n)
    if split:
        c.model_in(tokens * d * e)
        if kind == "mamba":
            c.t.add("all-to-all", tokens * di * e,
                    back=("all-to-all", tokens * di * e))
        c.t.add("all-reduce", tokens * 4)  # the norm's sum of squares
        c.model_in(tokens * 4)
        for nbytes in sliced:
            c.t.grad("all-gather", nbytes)
    _row(c, di, d, tokens)


def _mla(c: _Ctx, cfg, tokens) -> None:
    d, H, dh, dr = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.mla_rope_dim
    dc, dq = cfg.mla_kv_comp, cfg.mla_q_comp
    Dm, e = c.Dm, c.e
    _col(c, d, dq)
    if _split(dq, Dm) or _split(dc, Dm):
        c.model_in(tokens * d * e)  # x into w_dq and w_dkv
    if _split(dq, Dm):
        c.t.add("all-gather", tokens * dq * e)  # cq whole
    _col(c, dq, H * dh)
    _col(c, dq, H * dr)
    if _split(H * dh, Dm) or _split(H * dr, Dm):
        c.model_in(tokens * dq * e)  # cq into w_uq and w_qr
    local = Dm > 1 and H % Dm == 0 and _split(H * dh, Dm) and _split(H * dr, Dm)
    if not local:
        for n in (H * dh, H * dr):
            if _split(n, Dm):
                c.t.add("all-gather", tokens * n * e)
    _col(c, d, dc)
    if _split(dc, Dm):
        c.t.add("all-gather", tokens * dc * e)  # ckv whole
    if local:  # the rank's heads over the whole latents and rope key
        c.model_in(tokens * dc * e)
        c.model_in(tokens * dr * e)
    for _ in ("w_uk", "w_uv"):  # up-projections, in the attention
        _col(c, dc, H * dh)
        if not local and _split(H * dh, Dm):
            c.t.add("all-gather", dc * H * dh * e)
    _row(c, H * dh, d, tokens, whole_in=not local)


def _moe(c: _Ctx, cfg, B: int, S: int) -> None:
    """One MoE layer over the global batch (B, S)."""
    Dd, Dm, e, t = c.Dd, c.Dm, c.e, c.t
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    T = B * S
    G = Dd if Dd > 1 else 1
    if T % G or T // G < 8:
        G = 1
    T_loc = T // G
    cap = cfg.moe_capacity(T_loc)
    split = c.bs
    if G == 1 and split:  # every token into the one group
        c.data_gather(T * d * e)
    if G > 1 and not split:  # the group's tokens sliced from the whole batch
        t.grad("all-gather", T * d * e)
    varied = False
    if E >= 64:
        E_l, d_l = _local(E, Dd), _local(d, Dm)
        if d_l < d:
            t.grad("all-gather", T_loc * d * e)  # x sliced to the d block
            c.model_in(T_loc * cfg.moe_top_k * 4)  # the f32 gates
        if E_l < E and G > 1:
            t.add("all-to-all", E * cap * d_l * e,
                  back=("all-to-all", E * cap * d_l * e))
        if E_l < E and G == 1 and not split:  # the experts sliced
            t.grad("all-gather", E * cap * d_l * e)
        Gx = Dd if (E_l < E and G > 1) else 1
        if d_l < d:
            t.add("all-reduce", E_l * Gx * cap * f * e, 2)  # h and u
            c.model_in(E_l * Gx * cap * f * e)
        if E_l < E:  # back: an all-to-all, or all-gather of the experts
            if G > 1:
                t.add("all-to-all", E * cap * d_l * e,
                      back=("all-to-all", E * cap * d_l * e))
            else:
                c.data_gather(E * cap * d_l * e)
        if d_l < d:
            t.add("all-gather", T_loc * d * e)
    else:
        f_l = _local(f, Dm)
        if f_l < f:
            c.model_in(T_loc * d * e)
            varied = True
        if _split(d, Dd):
            for _ in range(2):  # w_gate, w_up
                c.data_gather(E * d * f_l * e)
            c.data_gather(E * f_l * d * e)  # w_down
        if f_l < f:
            t.add("all-reduce", E * cap * d * e)
    if cfg.n_shared_experts:
        _swiglu(c, d, f * cfg.n_shared_experts, T_loc, varied)
    if G > 1 and not split:
        t.add("all-gather", T * d * e)  # every group's tokens


RECURRENT = ("mamba", "mlstm", "slstm")


def _block(c: _Ctx, cfg, kind, B, S, S_mem: int = 0) -> None:
    rows = B // c.Dd if c.bs else B
    tokens = rows * S
    if kind in RECURRENT:
        _recurrent(c, cfg, kind, tokens)
        return
    if kind in ("mla_dense", "mla_moe"):
        _mla(c, cfg, tokens)
    else:
        _gqa(c, cfg, tokens)
    if kind == "cross_attn":  # the memory's rows, every feature
        _gqa(c, cfg, tokens, rows * S_mem)
    if kind in ("moe", "mla_moe"):
        _moe(c, cfg, B, S)
    else:
        _mlp(c, cfg, tokens)


def _embed(c: _Ctx, cfg, rows: int) -> None:
    if _split(cfg.vocab, c.Dm):
        c.t.add("all-reduce", rows * cfg.d_model * c.e)


def _head(c: _Ctx, cfg, B: int, Bl: int, S: int) -> None:
    """The logits of S positions of the rank's Bl rows, gathered over
    "model"."""
    d, V, e, Dm = cfg.d_model, cfg.vocab, c.e, c.Dm
    v_l = _local(V, Dm)
    if cfg.tie_embeddings:
        if v_l < V:
            c.model_in(Bl * S * d * e)
    else:
        from ..models.lm import head_stationary

        if head_stationary(Bl, B, S, d, _local(d, c.Dd), v_l):
            d_l = _local(d, c.Dd)
            if Bl < B:
                c.data_gather(B * S * d * e)
                if v_l < V:
                    c.model_in(B * S * d_l * e)
                c.t.add("reduce-scatter", Bl * S * v_l * e,
                        back=("all-gather", B * S * v_l * e))
            else:
                c.t.grad("all-gather", B * S * d * e)  # h sliced over "data"
                if v_l < V:
                    c.model_in(B * S * d_l * e)
                c.t.add("all-reduce", B * S * v_l * e)
        else:
            _col(c, d, V)
            if v_l < V:
                c.model_in(Bl * S * d * e)
    if v_l < V:
        c.t.add("all-gather", Bl * S * V * e)


def _encode(c: _Ctx, cfg, B: int, S_enc: int) -> None:
    """``lm.encode`` of (B, S_enc) frames: the column-parallel ``in_proj``
    and its output gathered over "model" (the frames take no gradient, so
    no ``model_in``; the gather's transpose is a slice), then the
    encoder's blocks."""
    d = cfg.d_model
    rows = B // c.Dd if c.bs else B
    _col(c, d, d)
    if _split(d, c.Dm):
        c.t.add("all-gather", rows * S_enc * d * c.e)
    for _ in range(cfg.encoder_layers):
        _block(c, cfg, "attn", B, S_enc)


def forward_collectives(cfg, shape, B: int, S: int, itemsize: int,
                        S_mem: int = 0) -> _Tally:
    """A forward pass (prefill of S tokens, or a decode step at S = 1)
    over the global batch B: the embedding's psum, every block's (a
    ``cross_attn`` block's over S_mem positions of encoder memory), and
    the last position's logits gathered over "model"."""
    t = _Tally()
    c = _Ctx(t, shape[0], shape[1], itemsize, B)
    Bl = B // c.Dd if c.bs else B
    _embed(c, cfg, Bl * S)
    for kind in cfg.prefix_pattern:
        _block(c, cfg, kind, B, S, S_mem)
    for _ in range(cfg.n_repeats):
        for kind in cfg.block_pattern:
            _block(c, cfg, kind, B, S, S_mem)
    _head(c, cfg, B, Bl, 1)
    return t


def serve_collectives(cfg, shape, B: int, S: int, steps: int,
                      itemsize: int, S_mem: int = 0) -> dict:
    """``{"calls", "bytes"}`` by kind of a prefill of (B, S) and ``steps``
    decode steps (``lm.prefill`` / ``lm.decode_step``; ``Server.generate``
    adds one all-gather of (B, 1) int32 tokens per token where the batch
    is split over "data").  An encoder-decoder's blocks read S_mem
    positions of encoder memory; the encoder passes that make it are
    :func:`encode_collectives`."""
    t = forward_collectives(cfg, shape, B, S, itemsize, S_mem)
    t.add_all(forward_collectives(cfg, shape, B, 1, itemsize, S_mem), steps)
    return t.out()


def encode_collectives(cfg, shape, B: int, S_enc: int, itemsize: int) -> dict:
    """``{"calls", "bytes"}`` by kind of one ``lm.encode`` of (B, S_enc)
    frames."""
    t = _Tally()
    _encode(_Ctx(t, shape[0], shape[1], itemsize, B), cfg, B, S_enc)
    return t.out()


def moe_collectives(cfg, shape, B: int, S: int, itemsize: int) -> dict:
    """``{"calls", "bytes"}`` by kind of one ``moe_apply`` over (B, S)."""
    t = _Tally()
    _moe(_Ctx(t, shape[0], shape[1], itemsize, B), cfg, B, S)
    return t.out()


def _mtp_kind(cfg) -> str:
    return cfg.prefix_pattern[0] if cfg.prefix_pattern else cfg.block_pattern[0]


def _train_pass(t: _Tally, cfg, shape, B: int, S: int, remat: str, e: int,
                S_mem: int = 0) -> None:
    """One forward and backward of ``lm.loss_fn`` over a global batch
    (B, S): an enc-dec arch's encoder pass over (B, S_mem) frames (not
    rematerialized) and the one ``model_in`` sum of its memory's gradient
    over every decoder layer, the forward's collectives with their
    transposes, the ``model_in`` sums, the recompute of every repeat
    (``remat="full"``: the repeat's whole forward again, zamba2's shared
    block once an invocation), the loss's psum and the sums of the
    replicated params' gradients."""
    c = _Ctx(t, shape[0], shape[1], e, B)
    Bl = B // c.Dd if c.bs else B
    if cfg.encoder_layers:
        _encode(c, cfg, B, S_mem)
        if _split(cfg.n_kv_heads * cfg.head_dim, c.Dm):
            c.model_in(Bl * S_mem * cfg.d_model * e)
    _embed(c, cfg, Bl * S)
    for kind in cfg.prefix_pattern:
        _block(c, cfg, kind, B, S, S_mem)
    for _ in range(cfg.n_repeats):
        for kind in cfg.block_pattern:
            _block(c, cfg, kind, B, S, S_mem)
    if remat != "none" and cfg.n_repeats:
        again = _Ctx(_Tally(), shape[0], shape[1], e, B)
        for kind in cfg.block_pattern:
            _block(again, cfg, kind, B, S, S_mem)
        t.add_all(again.t, cfg.n_repeats)
    _head(c, cfg, B, Bl, S)
    losses = 1
    if cfg.mtp_depth:
        d = cfg.d_model
        _embed(c, cfg, Bl * S)
        _col(c, 2 * d, d)
        if _split(d, c.Dm):
            c.model_in(Bl * S * 2 * d * e)
            c.t.add("all-gather", Bl * S * d * e)
        _block(c, cfg, _mtp_kind(cfg), B, S)
        _head(c, cfg, B, Bl, S)
        losses = 2
    if c.bs:
        t.add("all-reduce", 8, losses)  # each loss's (sum, count)
        for nbytes in _replicated_grad_bytes(cfg, shape, e).values():
            t.add("all-reduce", nbytes)


def _replicated_grad_bytes(cfg, shape, e: int) -> dict:
    """{dtype: bytes} of a rank's float param blocks that no batch axis
    splits: the gradients ``launch.steps.sum_replicated_grads`` sums."""
    from ..models import lm
    from ..runtime.elastic import make_shardings, sanitize_shardings, spec_axes
    from ..tree import leaves

    dtype = {2: torch.bfloat16, 4: torch.float32}[e]
    mesh = dry_process_mesh(shape, AXES)
    params = abstract_params(cfg, dtype)
    sh = sanitize_shardings(make_shardings(mesh, lm.param_specs(cfg)), params)
    out: dict = {}
    for p, s in zip(leaves(params), leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))):
        if p.is_floating_point() and p.numel() and "data" not in spec_axes(s.spec):
            n = 1
            for k in s.shard_shape(p.shape):
                n *= k
            out[p.dtype] = out.get(p.dtype, 0) + n * p.element_size()
    return out


def _float_leaves(cfg) -> int:
    from ..tree import leaves

    return sum(1 for p in leaves(abstract_params(cfg)) if p.is_floating_point())


def train_collectives(cfg, shape, B: int, S: int, remat: str = "full", *,
                      microbatches: int = 1, quantized: bool = False,
                      itemsize: int = 2, S_mem: int = 0) -> dict:
    """``{"calls", "bytes"}`` by kind of one ``launch.steps.
    make_train_step`` step on a rank of a (data, model) mesh of ``shape``
    over the global batch (B, S) of ``itemsize``-byte params and
    activations (an enc-dec arch's batch also carries (B, S_mem) frames):
    per microbatch (B / ``microbatches`` rows each) the encoder's pass, the
    forward's collectives, the recompute's (``remat="full"``), the
    transposes' and the ``model_in`` sums, the losses' psums and the
    gradient sums of the params replicated over "data" (one psum per
    dtype, where the batch is split); then the clip's psum over the mesh
    and, with int8 moments (``quantized``), the all-gather of every leaf's
    two maxima."""
    if remat not in ("full", "none"):
        raise NotImplementedError(f"remat={remat!r}: the closed form counts "
                                  f"'full' and 'none'")
    t = _Tally(train=True)
    for _ in range(microbatches):
        _train_pass(t, cfg, shape, B // microbatches, S, remat, itemsize, S_mem)
    world = shape[0] * shape[1]
    if world > 1:
        t.add("all-reduce", 4)  # the global norm's psum
        if quantized:
            t.add("all-gather", world * 2 * _float_leaves(cfg) * 4)
    return t.out()


def train_block_kernel_launches(cfg, microbatches: int = 1,
                                remat: str = "full") -> int:
    """A rank's block-kernel launches in one train step: per sparse
    projection of a repeat's dense-FFN block (zamba2's shared block once
    an invocation; the MoE and recurrent blocks have none), the forward,
    the recompute (``remat="full"``) and grad x on Wᵀ; of a prefix block,
    the MTP block or an encoder layer (not rematerialized), the forward
    and grad x."""
    if cfg.ffn_density >= 1.0:
        return 0
    none = ("moe", "mla_moe") + RECURRENT
    dense = sum(1 for k in cfg.block_pattern if k not in none)
    once = sum(1 for k in cfg.prefix_pattern if k not in none) + cfg.encoder_layers
    if cfg.mtp_depth and _mtp_kind(cfg) not in none:
        once += 1
    per = 3 if remat != "none" else 2
    return 3 * microbatches * (per * dense * cfg.n_repeats + 2 * once)


def block_kernel_launches(cfg, forwards: int) -> int:
    """A rank's block-kernel launches over ``forwards`` forward passes: one
    per sparse projection of each dense-FFN block it runs (prefix and
    repeats; the MoE and recurrent blocks have none, and the MTP block is
    not on the serving path; the encoder's are
    :func:`encode_block_kernel_launches`)."""
    if cfg.ffn_density >= 1.0:
        return 0
    kinds = list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.n_repeats
    dense = sum(1 for k in kinds if k not in ("moe", "mla_moe") + RECURRENT)
    return 3 * dense * forwards


def encode_block_kernel_launches(cfg) -> int:
    """A rank's block-kernel launches in one ``lm.encode``: one per sparse
    projection of each encoder block."""
    return 3 * cfg.encoder_layers if cfg.ffn_density < 1.0 else 0
