"""Recurrent / linear-attention blocks: Mamba2 (SSD), mLSTM, sLSTM.

Counterpart of ``repro/models/linear_attn.py``.  One chunked
gated-linear-attention primitive serves both Mamba2's SSD (scalar-per-head
decay, arXiv:2405.21060 form) and xLSTM's mLSTM (matrix memory with
exponential gating, arXiv:2405.04517): both keep a per-head matrix state S
(dk x dv) updated as

    S_t = a_t * S_{t-1} + k_t v_t^T        (a_t in (0,1], data-dependent)
    y_t = q_t @ S_t   (+ normalizer)

The full-sequence path is the chunkwise-parallel form (intra-chunk
attention products, then the inter-chunk state recurrence, a Python loop
over the chunks where the reference has a ``lax.scan``); decode is the O(1)
state recurrence.  sLSTM keeps its sequential scalar recurrence, a Python
loop over the sequence.  Every product is a plain ``torch.einsum`` /
``torch.matmul``, as the reference's are plain ``jnp``: no TPU kernel
computes any of this.

The reference's simplifications are kept for parity (ROADMAP.md §3): the
Mamba2 block has no causal convolution and its B / C projections are per
head; mLSTM's normalizer is max(|q . n|, 1), not a stabilized maximum.
The ``*_spec`` functions are the reference's PartitionSpec trees.

On a process mesh (``core.sharding.set_mesh``) each rank runs its heads,
as the specs place the weights: the column-parallel projections' outputs
are the rank's heads (``common.col_apply``), the state is the rank's
heads, the norm over the heads' features is one psum of a partial sum of
squares over "model" (``common.rmsnorm(..., d=)``), and ``out_proj`` is
row-parallel (a psum over "model").  The per-token loops (the GLA chunks,
sLSTM's cell) stay local to the rank: no collective a token, forward or
backward.  Mamba2's ``in_proj`` is column-parallel over its ``2 d_inner``
columns ``[x | z]``, so a rank's block holds x's or z's columns, not its
heads' of both: one all-to-all over "model" of the local product moves
them (:func:`_mamba2_xz`).  A "model" extent that does not divide the
heads raises ``NotImplementedError``: a head is never split, and the block
is never silently replicated.

Under autograd the sharded program is differentiable, with
``core/sharding.py``'s convention: the block's input enters the rank's
heads through ``model_in`` (its gradient summed over "model"), Mamba2's
all-to-all is the collectives' differentiable one (its transpose the
reverse all-to-all), and the leaves replicated over "model" that a rank
slices to its heads (Mamba2's ``a_log``, ``d_skip`` and norm scale, the
xLSTM blocks' norm scale) take the slice's transpose, an all-gather: every
rank holds the whole gradient of the leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import sharding as SH
from ..core.sharding import P
from .common import (col_apply, dense_apply, dense_init, dense_spec, model_block,
                     rmsnorm, rmsnorm_init, row_apply)

__all__ = [
    "gla_chunked",
    "gla_step",
    "mamba2_init",
    "mamba2_spec",
    "mlstm_spec",
    "slstm_spec",
    "mamba2_apply",
    "mamba2_decode",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_decode",
    "slstm_init",
    "slstm_apply",
    "slstm_decode",
    "slstm_zero_state",
    "softplus",
    "RecurrentState",
    "SLSTMState",
]


class RecurrentState(NamedTuple):
    s: torch.Tensor  # (B, H, dk, dv) matrix state
    n: torch.Tensor  # (B, H, dk) normalizer state (mLSTM) or unused (mamba2)


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype and device.  The
    reference's ``jnp.maximum`` / ``jnp.minimum`` against a constant are
    written as ``torch.maximum`` / ``torch.minimum`` against this: at a tie
    both split the gradient in halves, where ``torch.clamp`` would pass all
    of it (sLSTM's normalizer is exactly 1 on its first step wherever
    z_i >= z_f)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# chunked gated linear attention (shared primitive)
# ---------------------------------------------------------------------------


def gla_chunked(q, k, v, log_a, chunk: int = 256, normalize: bool = False):
    """Chunkwise-parallel gated linear attention, in float32 throughout.

    q/k/v: (B, S, H, dk|dv); log_a: (B, S, H) per-step log decay (<= 0).
    Returns (y (B, S, H, dv) float32, final RecurrentState).  The chunk is
    ``min(chunk, S)`` and must divide S.  ``normalize=True`` divides by
    max(|n_inter + n_intra|, 1), the reference's simplified normalizer.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {C}")
    NC = S // C

    def resh(x):
        return x.reshape(B, NC, C, H, -1).float()

    qc, kc, vc = resh(q), resh(k), resh(v)
    la = log_a.reshape(B, NC, C, H).float()
    cum = torch.cumsum(la, dim=2)  # within-chunk cumulative log decay
    total = cum[:, :, -1, :]  # (B, NC, H)

    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (q_i.k_j) v_j
    scores = torch.einsum("bnihd,bnjhd->bnhij", qc, kc)
    cum_h = cum.transpose(2, 3)  # (B, NC, H, C)
    decay = cum_h[..., :, None] - cum_h[..., None, :]  # (B,NC,H,i,j) = cum_i - cum_j
    causal = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    w = torch.where(causal, torch.exp(torch.minimum(decay, _scalar(decay, 0.0))), 0.0)
    sw = scores * w
    intra = torch.einsum("bnhij,bnjhd->bnihd", sw, vc)

    # inter-chunk recurrence over NC chunks; chunk n's state contribution:
    # sum_j exp(total_n - cum_j) k_j v_j^T
    k_tail = kc * torch.exp(total[:, :, None] - cum)[..., None]
    kv = torch.einsum("bnjhk,bnjhv->bnhkv", k_tail, vc)
    k_dec = k_tail.sum(dim=2)  # (B, NC, H, dk)
    q_dec = qc * torch.exp(cum)[..., None]  # (B, NC, C, H, dk)
    s = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
    inter, n_inter = [], []
    for c in range(NC):
        dec = torch.exp(total[:, c])  # (B, H)
        inter.append(torch.einsum("bihk,bhkv->bihv", q_dec[:, c], s))
        n_inter.append(torch.einsum("bihk,bhk->bih", q_dec[:, c], n))
        s = dec[:, :, None, None] * s + kv[:, c]
        n = dec[:, :, None] * n + k_dec[:, c]
    y = intra + torch.stack(inter, dim=1)  # (B, NC, C, H, dv)
    if normalize:
        n_intra = sw.sum(dim=-1).transpose(2, 3)  # (B, NC, C, H)
        denom = torch.abs(torch.stack(n_inter, dim=1) + n_intra)
        y = y / torch.maximum(denom[..., None], _scalar(denom, 1.0))
    return y.reshape(B, S, H, dv), RecurrentState(s, n)


def gla_step(state: RecurrentState, q, k, v, log_a, normalize: bool = False):
    """One-token recurrence (decode). q/k/v: (B, 1, H, d).  Returns (y (B,
    1, H, dv) in q's dtype, the new RecurrentState); ``n`` gains the
    un-decayed key."""
    a = torch.exp(log_a.float())[:, 0, :, None, None]  # (B, H, 1, 1)
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    s = a * state.s + torch.einsum("bhk,bhv->bhkv", kf, vf)
    n = a[..., 0] * state.n + kf
    y = torch.einsum("bhk,bhkv->bhv", qf, s)
    if normalize:
        denom = torch.abs(torch.einsum("bhk,bhk->bh", qf, n))
        y = y / torch.maximum(denom[..., None], _scalar(denom, 1.0))
    return y[:, None].to(q.dtype), RecurrentState(s, n)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no switch to the identity
    above a threshold (``F.softplus`` has one at 20; in float32 the two
    agree there, since log1p(exp(-20)) is below half an ulp of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2's SSM component) — SSD parameterization
# ---------------------------------------------------------------------------


def mamba2_init(gen, cfg, dtype=torch.bfloat16):
    """d_inner = cfg.ssm_d_inner, ssm_heads heads, state = ssm_state; the
    decay rates and the skip are float32 whatever ``dtype``."""
    d, di, H = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype),  # x and gate z
        "bc_proj": dense_init(gen, d, 2 * cfg.ssm_state * H, dtype),  # B, C
        "dt_proj": dense_init(gen, d, H, dtype),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
        "norm": rmsnorm_init(di, dtype, dev),
    }


def mamba2_spec(cfg) -> dict:
    return {
        "in_proj": dense_spec("col"),
        "bc_proj": dense_spec("col"),
        "dt_proj": dense_spec("col"),
        "a_log": P(None),
        "d_skip": P(None),
        "out_proj": dense_spec("row"),
        "norm": {"scale": P(None)},
    }


def _check_heads(n_heads: int) -> None:
    """Raise where the ambient mesh's "model" extent splits a head."""
    n = SH.axis_size("model")
    if n > 1 and n_heads % n:
        raise NotImplementedError(
            f"a recurrent block of {n_heads} heads has no sharded program "
            f"over {n} ranks of 'model': a rank would hold part of a head")


def _heads_of(p, x, full: int) -> torch.Tensor:
    """A column-parallel product of x split by heads over its ``full``
    columns: this rank's block (sliced from the whole where the sanitized
    spec left the weight whole)."""
    return model_block(col_apply(p, x, full), full)


def _mamba2_xz(p, x, di: int) -> tuple:
    """(x, z) of this rank's heads from ``in_proj``'s ``[x | z]``.

    With n ranks over "model", the 2 d_inner columns are 2n blocks of
    d_inner / n; rank s holds blocks 2s and 2s + 1 and rank r needs blocks
    r (its x) and n + r (its z).  One all-to-all over "model" sends block q
    to rank q mod n in slot q mod n of a buffer of n slots (the others
    zeros, as an all-to-all moves equal slots): rank r receives its x from
    rank r // 2 and its z from rank (n + r) // 2.  ``in_proj`` stays as the
    reference's spec shards it."""
    xz = col_apply(p, x, 2 * di)
    if xz.shape[-1] == 2 * di:
        xin, z = xz.chunk(2, dim=-1)
        return model_block(xin, di), model_block(z, di)
    n, s = SH.axis_size("model"), SH.axis_index("model")
    w = di // n
    slots = [xz.new_zeros(xz.shape[:-1] + (w,))] * n
    slots[(2 * s) % n], slots[(2 * s + 1) % n] = xz[..., :w], xz[..., w:]
    got = SH.collectives().all_to_all(torch.cat(slots, dim=-1), "model",
                                      split_dim=xz.ndim - 1,
                                      concat_dim=xz.ndim - 1)
    xs, zs = s // 2, (n + s) // 2
    return got[..., xs * w:(xs + 1) * w], got[..., zs * w:(zs + 1) * w]


def _mamba2_qkv(p, x, cfg):
    B, S, _ = x.shape
    H, N = cfg.ssm_heads, cfg.ssm_state
    dh = cfg.ssm_d_inner // H
    _check_heads(H)
    xin, z = _mamba2_xz(p["in_proj"], x, cfg.ssm_d_inner)
    Hl = xin.shape[-1] // dh  # this rank's heads
    bc = _heads_of(p["bc_proj"], x, 2 * N * H).reshape(B, S, Hl, 2 * N)
    b, c = bc.chunk(2, dim=-1)
    dt = softplus(_heads_of(p["dt_proj"], x, H).float())  # (B, S, Hl)
    log_a = -torch.exp(model_block(p["a_log"], H))[None, None, :] * dt  # <= 0
    v = xin.reshape(B, S, Hl, dh) * dt[..., None].to(xin.dtype)
    return b, c, v, log_a, z, xin


def _mamba2_out(p, y, xin, z, x, cfg):
    """y + D x, cast to x's dtype, gated by silu(z), normed, projected."""
    B, S, d = x.shape
    Hl = y.shape[2]
    d_skip = model_block(p["d_skip"], cfg.ssm_heads)
    y = y + d_skip[None, None, :, None] * xin.reshape(B, S, Hl, -1).float()
    y = y.reshape(B, S, -1).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), d=cfg.ssm_d_inner)
    return row_apply(p["out_proj"], y, cfg.ssm_d_inner, d)


def mamba2_apply(p, x, cfg, chunk: int = 256):
    """SSD: y = GLA(q=C, k=B, v=dt*x, decay=exp(-exp(A) dt)) + D*x, gated."""
    b, c, v, log_a, z, xin = _mamba2_qkv(p, x, cfg)
    y, state = gla_chunked(c, b, v, log_a, chunk=chunk)
    return _mamba2_out(p, y, xin, z, x, cfg), state


def mamba2_decode(p, x, state: RecurrentState, cfg):
    b, c, v, log_a, z, xin = _mamba2_qkv(p, x, cfg)
    y, state = gla_step(state, c, b, v, log_a)
    return _mamba2_out(p, y, xin, z, x, cfg), state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM) — matrix memory, exponential input gate
# ---------------------------------------------------------------------------


def mlstm_init(gen, cfg, dtype=torch.bfloat16):
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "w_ig": dense_init(gen, d, H, dtype),  # input gate (exp)
        "w_fg": dense_init(gen, d, H, dtype),  # forget gate (sigmoid)
        "out_proj": dense_init(gen, d, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


def mlstm_spec(cfg) -> dict:
    return {
        "wq": dense_spec("col"),
        "wk": dense_spec("col"),
        "wv": dense_spec("col"),
        "w_ig": dense_spec("col"),
        "w_fg": dense_spec("col"),
        "out_proj": dense_spec("row"),
        "norm": {"scale": P(None)},
    }


def _mlstm_qkv(p, x, cfg):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    _check_heads(H)
    q, k, v = (_heads_of(p[n], x, d) for n in ("wq", "wk", "wv"))
    Hl = q.shape[-1] // dh  # this rank's heads
    q = q.reshape(B, S, Hl, dh) / math.sqrt(dh)
    k, v = k.reshape(B, S, Hl, dh), v.reshape(B, S, Hl, dh)
    log_f = F.logsigmoid(_heads_of(p["w_fg"], x, H).float())
    ig = _heads_of(p["w_ig"], x, H).float()
    # fold the (stabilized) exponential input gate into k
    k = k * torch.exp(torch.minimum(ig, _scalar(ig, 0.0)))[..., None].to(k.dtype)
    return q, k, v, log_f


def _xlstm_out(p, y, x):
    """mLSTM's / sLSTM's heads (this rank's) merged, cast to x's dtype,
    normed over d_model, projected (row-parallel)."""
    d = x.shape[-1]
    y = y.reshape(x.shape[:-1] + (-1,)).to(x.dtype)
    return row_apply(p["out_proj"], rmsnorm(p["norm"], y, d=d), d, d)


def mlstm_apply(p, x, cfg, chunk: int = 256):
    q, k, v, log_f = _mlstm_qkv(p, x, cfg)
    y, state = gla_chunked(q, k, v, log_f, chunk=chunk, normalize=True)
    return _xlstm_out(p, y, x), state


def mlstm_decode(p, x, state: RecurrentState, cfg):
    q, k, v, log_f = _mlstm_qkv(p, x, cfg)
    y, state = gla_step(state, q, k, v, log_f, normalize=True)
    return _xlstm_out(p, y, x), state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — scalar memory, true sequential recurrence
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg, dtype=torch.bfloat16):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    w_in = dense_init(gen, d, 4 * d, dtype)  # i, f, z, o pre-activations
    r = torch.randn((H, dh, 4 * dh), generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(1.0 / math.sqrt(dh))
    return {
        "w_in": w_in,
        "r": r,  # block-diagonal recurrent weights, float32
        "out_proj": dense_init(gen, d, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor  # stabilizer


def slstm_spec(cfg) -> dict:
    return {
        "w_in": dense_spec("col"),
        "r": P("model", None, None),  # heads over model axis
        "out_proj": dense_spec("row"),
        "norm": {"scale": P(None)},
    }


def slstm_zero_state(B, cfg, device=None, heads=None):
    """Zero state of ``heads`` heads (default: all of them)."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    H = H if heads is None else heads
    z = torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, z)


def _slstm_cell(p, state: SLSTMState, pre):
    """pre: (B, H, 4*dh) input pre-activations for one step; ``p["r"]``
    the H heads' recurrent weights."""
    rec = torch.einsum("bhd,hde->bhe", state.h, p["r"])  # (B, H, 4dh)
    z_i, z_f, z_z, z_o = (pre.float() + rec).chunk(4, dim=-1)
    m_new = torch.maximum(z_f + state.m, z_i)  # log-space stabilizer
    i = torch.exp(z_i - m_new)
    f = torch.exp(z_f + state.m - m_new)
    c = f * state.c + i * torch.tanh(z_z)
    n = f * state.n + i
    h = torch.sigmoid(z_o) * c / torch.maximum(n, _scalar(n, 1.0))
    return SLSTMState(c, n, h, m_new)


def _slstm_pre(p, x, cfg) -> tuple:
    """(pre-activations (B, S, Hl, 4 dh) of this rank's Hl heads, {"r":
    their recurrent weights})."""
    B, S, d = x.shape
    H = cfg.n_heads
    _check_heads(H)
    pre = _heads_of(p["w_in"], x, 4 * d)
    Hl = pre.shape[-1] * H // (4 * d)
    r = p["r"] if p["r"].shape[0] == Hl else SH.slice_dim(p["r"], "model", 0)
    return pre.reshape(B, S, Hl, 4 * (d // H)), {"r": r}


def slstm_apply(p, x, cfg):
    """The cell stepped over the sequence, one step per token."""
    pre, r = _slstm_pre(p, x, cfg)
    state = slstm_zero_state(x.shape[0], cfg, x.device, heads=pre.shape[2])
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_cell(r, state, pre[:, t])
        hs.append(state.h)
    return _xlstm_out(p, torch.stack(hs, dim=1), x), state


def slstm_decode(p, x, state: SLSTMState, cfg):
    pre, r = _slstm_pre(p, x, cfg)
    state = _slstm_cell(r, state, pre[:, 0])
    return _xlstm_out(p, state.h, x), state
