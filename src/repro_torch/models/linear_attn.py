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
The ``*_spec`` functions are the reference's PartitionSpec trees, data
only: ``lm.param_specs`` needs them for every arch.  The recurrent kinds'
sharded apply is a later step of ROADMAP.md §1 item 7 (``blocks.
check_mesh_kind`` raises for them on a mesh).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.sharding import P
from .common import dense_apply, dense_init, dense_spec, rmsnorm, rmsnorm_init

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


def _mamba2_qkv(p, x, cfg):
    B, S, _ = x.shape
    H, N = cfg.ssm_heads, cfg.ssm_state
    dh = cfg.ssm_d_inner // H
    xin, z = dense_apply(p["in_proj"], x).chunk(2, dim=-1)
    b, c = dense_apply(p["bc_proj"], x).reshape(B, S, H, 2 * N).chunk(2, dim=-1)
    dt = softplus(dense_apply(p["dt_proj"], x).float())  # (B, S, H)
    log_a = -torch.exp(p["a_log"])[None, None, :] * dt  # (B, S, H), <= 0
    v = xin.reshape(B, S, H, dh) * dt[..., None].to(xin.dtype)
    return b, c, v, log_a, z, xin


def _mamba2_out(p, y, xin, z, x, cfg):
    """y + D x, cast to x's dtype, gated by silu(z), normed, projected."""
    B, S, _ = x.shape
    H = cfg.ssm_heads
    y = y + p["d_skip"][None, None, :, None] * xin.reshape(B, S, H, -1).float()
    y = y.reshape(B, S, cfg.ssm_d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return dense_apply(p["out_proj"], y)


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
    q = dense_apply(p["wq"], x).reshape(B, S, H, dh) / math.sqrt(dh)
    k = dense_apply(p["wk"], x).reshape(B, S, H, dh)
    v = dense_apply(p["wv"], x).reshape(B, S, H, dh)
    log_f = F.logsigmoid(dense_apply(p["w_fg"], x).float())
    ig = dense_apply(p["w_ig"], x).float()
    # fold the (stabilized) exponential input gate into k
    k = k * torch.exp(torch.minimum(ig, _scalar(ig, 0.0)))[..., None].to(k.dtype)
    return q, k, v, log_f


def _xlstm_out(p, y, x):
    """mLSTM's / sLSTM's heads merged, cast to x's dtype, normed, projected."""
    y = y.reshape(x.shape).to(x.dtype)
    return dense_apply(p["out_proj"], rmsnorm(p["norm"], y))


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


def slstm_zero_state(B, cfg, device=None):
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, z)


def _slstm_cell(p, state: SLSTMState, pre):
    """pre: (B, H, 4*dh) input pre-activations for one step."""
    rec = torch.einsum("bhd,hde->bhe", state.h, p["r"])  # (B, H, 4dh)
    z_i, z_f, z_z, z_o = (pre.float() + rec).chunk(4, dim=-1)
    m_new = torch.maximum(z_f + state.m, z_i)  # log-space stabilizer
    i = torch.exp(z_i - m_new)
    f = torch.exp(z_f + state.m - m_new)
    c = f * state.c + i * torch.tanh(z_z)
    n = f * state.n + i
    h = torch.sigmoid(z_o) * c / torch.maximum(n, _scalar(n, 1.0))
    return SLSTMState(c, n, h, m_new)


def slstm_apply(p, x, cfg):
    """The cell stepped over the sequence, one step per token."""
    B, S, d = x.shape
    H = cfg.n_heads
    pre = dense_apply(p["w_in"], x).reshape(B, S, H, 4 * (d // H))
    state = slstm_zero_state(B, cfg, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, state, pre[:, t])
        hs.append(state.h)
    return _xlstm_out(p, torch.stack(hs, dim=1), x), state


def slstm_decode(p, x, state: SLSTMState, cfg):
    B, _, d = x.shape
    H = cfg.n_heads
    pre = dense_apply(p["w_in"], x).reshape(B, H, 4 * (d // H))
    state = _slstm_cell(p, state, pre)
    return _xlstm_out(p, state.h, x), state
