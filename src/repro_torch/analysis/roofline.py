"""Roofline arithmetic for the dry run (one NVIDIA H100).

Counterpart of ``repro/analysis/roofline.py``.  Per (arch x shape) cell,
three terms:

    compute_s    = FLOPs_per_card / 989e12     (bf16 dense tensor-core peak)
    memory_s     = bytes_per_card / 3.35e12    (HBM3)
    collective_s = coll_bytes     / 450e9      (NVLink, each way)

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled step and its collective bytes from the compiled HLO.  The port
compiles nothing: :mod:`repro_torch.analysis.count` counts a step run
eagerly on fake tensors, and :meth:`CostTerms.from_counted` reads that
count.  ``collective_bytes`` (an HLO parser) is not ported: the port has
no HLO.  Its successor is the count each collective of a process mesh
keeps (``repro_torch.core.collectives``: bytes of each result by kind,
the names HLO gives them); :meth:`CostTerms.from_counted` takes it as
``collectives=`` and prices it at ``LINK_BW``.  On one card no collective
runs and ``coll_bytes`` stays 0.

Scan corrections.  XLA counts a ``while`` body once, so the reference
adds the sLSTM time scan's and the GLA inter-chunk scan's missing
iterations analytically.  An eager count sees every GLA chunk, so
:func:`gla_scan_correction` is ported for parity only and never added to
a port count.  sLSTM's per-token loop is counted the reference's way: the
dry run steps it once and adds :func:`slstm_scan_correction`
(``launch/dryrun.py``).

MODEL_FLOPS (the usefulness denominator) = 6*N*D for training (2*N*D
forward), N = active params; attention / SSM terms added analytically.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import SHAPES, ArchConfig

__all__ = [
    "PEAK_FLOPS",
    "HBM_BW",
    "LINK_BW",
    "CostTerms",
    "extrapolate",
    "roofline_report",
    "model_flops",
    "slstm_scan_correction",
    "gla_scan_correction",
    "GLA_CHUNK",
]

# One NVIDIA H100 SXM, from its data sheet (not measured).  They replace
# the reference's TPU v5e values: 197e12 FLOP/s bf16, 819e9 B/s HBM and
# 50e9 B/s per ICI link.
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
LINK_BW = 450e9  # bytes/s, NVLink 4 each way (data sheet); no link is used on one card

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}


@dataclass
class CostTerms:
    flops: float = 0.0  # per device
    bytes_hbm: float = 0.0  # per device
    coll_bytes: float = 0.0  # per device; 0 on one card
    notes: list = field(default_factory=list)

    @classmethod
    def from_counted(cls, counter, collectives=None) -> "CostTerms":
        """The terms of a finished :class:`~repro_torch.analysis.count.Count`
        (its FLOPs and bytes) and, on a process mesh, its rank's
        collectives (``Collectives.snapshot()``: ``total_bytes``); one
        card moves no collective bytes."""
        coll = 0.0 if collectives is None else float(collectives["total_bytes"])
        return cls(flops=float(counter.flops), bytes_hbm=float(counter.bytes),
                   coll_bytes=coll)

    def scaled(self, k: float) -> "CostTerms":
        return CostTerms(self.flops * k, self.bytes_hbm * k, self.coll_bytes * k)

    def plus(self, other: "CostTerms") -> "CostTerms":
        return CostTerms(
            self.flops + other.flops,
            self.bytes_hbm + other.bytes_hbm,
            self.coll_bytes + other.coll_bytes,
            self.notes + other.notes,
        )


def extrapolate(l1: CostTerms, l2: CostTerms, n_repeats: int) -> CostTerms:
    """total = outside + NR * per_layer, from unrolled L=1 / L=2 probes."""
    per_layer = CostTerms(
        max(l2.flops - l1.flops, 0.0),
        max(l2.bytes_hbm - l1.bytes_hbm, 0.0),
        max(l2.coll_bytes - l1.coll_bytes, 0.0),
    )
    outside = CostTerms(
        max(l1.flops - per_layer.flops, 0.0),
        max(l1.bytes_hbm - per_layer.bytes_hbm, 0.0),
        max(l1.coll_bytes - per_layer.coll_bytes, 0.0),
    )
    return outside.plus(per_layer.scaled(n_repeats))


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def _attn_flops_per_layer(cfg: ArchConfig, S: int, B: int, kind: str,
                          window: int | None) -> float:
    """Score+AV matmul flops (fwd), causal halving, optional window."""
    eff = S if window is None else min(S, window)
    per_q = eff / 2 if window is None else eff  # causal triangle vs band
    return 4.0 * B * S * per_q * cfg.n_heads * cfg.head_dim


def _layer_counts(cfg: ArchConfig) -> dict:
    counts: dict = {}
    for k in cfg.prefix_pattern:
        counts[k] = counts.get(k, 0) + 1
    for k in cfg.block_pattern:
        counts[k] = counts.get(k, 0) + cfg.n_repeats
    return counts


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """Analytic useful FLOPs for the cell (6ND train / 2ND forward + attn)."""
    sh = SHAPES[shape_name]
    return _model_flops(cfg, sh["seq_len"], sh["global_batch"], sh["kind"])


def _model_flops(cfg: ArchConfig, S: int, B: int, kind: str) -> float:
    """:func:`model_flops` of a step of batch ``B`` at length ``S``:
    ``kind`` "train", "prefill" or "decode" (one token a sequence against
    ``S`` cached)."""
    n_active = cfg.active_params()
    if kind == "train":
        tokens = S * B
        total = 6.0 * n_active * tokens
        mult = 3.0  # fwd + bwd
    elif kind == "prefill":
        tokens = S * B
        total = 2.0 * n_active * tokens
        mult = 1.0
    else:  # decode: one token per sequence
        tokens = B
        total = 2.0 * n_active * tokens
        mult = 1.0

    counts = _layer_counts(cfg)
    for k, n in counts.items():
        if k in ("attn", "attn_global", "moe", "shared_attn", "cross_attn",
                 "mla_dense", "mla_moe"):
            w = None
        elif k == "attn_local":
            w = cfg.sliding_window
        else:
            continue
        if k in ("attn", "moe", "cross_attn") and cfg.sliding_window:
            w = cfg.sliding_window
        if kind == "decode":
            eff = S if w is None else min(S, w)
            total += mult * n * 4.0 * B * eff * cfg.n_heads * cfg.head_dim
        else:
            total += mult * n * _attn_flops_per_layer(cfg, S, B, kind, w)
    # GLA/SSD chunked linear attention: ~ 2 * (C + 2*dk) per (token, head, dv)
    for k, n in counts.items():
        if k in ("mamba", "mlstm"):
            H = cfg.ssm_heads if k == "mamba" else cfg.n_heads
            dk = cfg.ssm_state if k == "mamba" else cfg.d_model // cfg.n_heads
            dv = (cfg.ssm_d_inner // cfg.ssm_heads) if k == "mamba" else (
                cfg.d_model // cfg.n_heads
            )
            C = 256
            if kind == "decode":
                total += mult * n * 2.0 * B * H * dk * dv * 2
            else:
                total += mult * n * 2.0 * B * S * H * dv * (C + 2 * dk)
        if k == "slstm":
            dh = cfg.d_model // cfg.n_heads
            steps = 1 if kind == "decode" else S
            total += mult * n * 2.0 * B * steps * cfg.n_heads * dh * 4 * dh
    return total


def slstm_scan_correction(cfg: ArchConfig, shape_name: str) -> float:
    """FLOPs a count misses when sLSTM's time loop is stepped once: its
    remaining (S - 1) steps' recurrent products."""
    counts = _layer_counts(cfg)
    n = counts.get("slstm", 0)
    if not n:
        return 0.0
    sh = SHAPES[shape_name]
    if sh["kind"] == "decode":
        return 0.0
    S, B = sh["seq_len"], sh["global_batch"]
    dh = cfg.d_model // cfg.n_heads
    mult = 3.0 if sh["kind"] == "train" else 1.0
    return mult * n * (S - 1) * 2.0 * B * cfg.n_heads * dh * 4 * dh


GLA_CHUNK = 256  # matches models/linear_attn.py default


def gla_scan_correction(cfg: ArchConfig, shape_name: str) -> float:
    """FLOPs XLA misses in the GLA inter-chunk recurrence (mamba/mlstm).

    Ported for parity with the reference only: its ``lax.scan`` is counted
    once by ``cost_analysis``, while the port's eager count sees every
    chunk, so adding this to a port count would count the chunks twice.
      body ~ 2*B*H*dk*(C*dv + C + 3*dv)   (inter + normalizer + state update)
    """
    counts = _layer_counts(cfg)
    sh = SHAPES[shape_name]
    if sh["kind"] == "decode":
        return 0.0
    S, B = sh["seq_len"], sh["global_batch"]
    C = min(GLA_CHUNK, S)
    NC = max(1, S // C)
    mult = 3.0 if sh["kind"] == "train" else 1.0
    total = 0.0
    for kind, n in counts.items():
        if kind == "mamba":
            H, dk = cfg.ssm_heads, cfg.ssm_state
            dv = cfg.ssm_d_inner // max(cfg.ssm_heads, 1)
        elif kind == "mlstm":
            H = cfg.n_heads
            dk = dv = cfg.d_model // cfg.n_heads
        else:
            continue
        body = 2.0 * B * H * dk * (C * dv + C + 3 * dv)
        total += mult * n * (NC - 1) * body
    return total


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


def roofline_report(cfg: ArchConfig, shape_name: str, chips: int,
                    total: CostTerms) -> dict:
    compute_s = total.flops / PEAK_FLOPS
    memory_s = total.bytes_hbm / HBM_BW
    coll_s = total.coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_name)
    hlo_total_flops = total.flops * chips
    bound = max(compute_s, memory_s, coll_s)
    return {
        "arch": cfg.name,
        "shape": shape_name,
        "chips": chips,
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        # the key keeps the reference's name; here it is the eager count's
        "hlo_flops_total": hlo_total_flops,
        "useful_ratio": mf / hlo_total_flops if hlo_total_flops else 0.0,
        # fraction of roofline: useful work per sec achievable / peak
        "roofline_fraction": (
            (mf / chips / PEAK_FLOPS) / bound if bound > 0 else 0.0
        ),
        "per_device": {
            "flops": total.flops,
            "bytes_hbm": total.bytes_hbm,
            "coll_bytes": total.coll_bytes,
        },
        "notes": total.notes,
    }
