"""Adaptive scheme selection — paper Recommendation #3 and Observations 15-18.

Counterpart of ``repro/core/adaptive.py`` with the same selection rules.
Only the hardware constants differ: :class:`HardwareModel` carries the
NVIDIA H100 SXM data-sheet figures instead of the TPU ones.  On one device
the chosen scheme does not depend on them (the 2D grid is (1, 1) whatever
the vertical-partition sweep prefers).

Decision rules distilled from the paper:
  * scale-free matrix (NNZ-r-std > 25)  -> 1D, element-granular COO balance
    (Obs. 5/18).
  * regular matrix                      -> 2D equally-sized (Obs. 18), COO
    over CSR (Obs. 16).
  * block pattern                       -> blocked format (BCOO) (Obs. 3).
  * equally-wide / variable-sized       -> never auto-selected (Obs. 14);
    kept for tuning candidates.
"""
from __future__ import annotations

from dataclasses import dataclass

from .stats import MatrixStats

__all__ = [
    "Plan",
    "HardwareModel",
    "select_scheme",
    "enumerate_schemes",
    "estimate_time",
]


@dataclass(frozen=True)
class HardwareModel:
    """Per-card NVIDIA H100 SXM data-sheet constants."""

    chips: int = 1
    peak_flops: float = 989e12  # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12  # HBM3 bytes/s
    link_bw: float = 450e9  # NVLink bytes/s, each way

    @classmethod
    def single_pod(cls) -> "HardwareModel":
        """A DGX H100 SuperPOD: 256 cards in one NVLink domain (the pod the
        JAX package's preset of the same name models, at 256 chips)."""
        return cls(chips=256)


@dataclass(frozen=True)
class Plan:
    partitioning: str  # "1d" | "2d"
    scheme: str  # balance (1d) or tile scheme (2d)
    fmt: str  # coo | csr | bcoo | bcsr
    merge: str  # none | ppermute | psum | psum_scatter | global
    grid: tuple  # (R, C) or (P, 1)
    reason: str

    @property
    def tag(self) -> str:
        """Canonical ``partitioning.scheme.fmt.merge`` identity string — the
        base of ``ExecutionPlan.scheme_id``."""
        return f"{self.partitioning}.{self.scheme}.{self.fmt}.{self.merge}"


def select_scheme(
    stats: MatrixStats, hw: HardwareModel, dtype_bytes: int = 4
) -> Plan:
    """Pick the paper-implied best scheme for a matrix on given hardware."""
    chips = hw.chips
    if stats.is_scale_free:
        fmt = "bcoo" if stats.is_block_pattern else "coo"
        return Plan(
            partitioning="1d",
            scheme="nnz",
            fmt=fmt,
            merge="ppermute",
            grid=(chips, 1),
            reason=(
                "scale-free (NNZ-r-std="
                f"{stats.nnz_r_std:.1f} > 25): perfect nnz balance beats 2D "
                "tile disparity (paper Obs. 5/18)"
            ),
        )
    fmt = "bcoo" if stats.is_block_pattern else "coo"
    C = _pick_vertical_partitions(stats, chips, dtype_bytes, hw)
    R = max(1, chips // C)
    return Plan(
        partitioning="2d",
        scheme="equally-sized",
        fmt=fmt,
        merge="psum_scatter",
        grid=(R, C),
        reason=(
            f"regular matrix: 2D equally-sized with C={C} vertical partitions "
            "balances x-load vs partial-merge traffic (paper Obs. 13/18)"
        ),
    )


def _pick_vertical_partitions(
    stats: MatrixStats, chips: int, dtype_bytes: int, hw: HardwareModel
) -> int:
    """Sweep C over powers of two minimizing the modeled collective time
    (paper §6.2.1): load = cols/C, merge = rows/R * 2; pick argmin."""
    best_c, best_t = 1, float("inf")
    c = 1
    while c <= chips:
        r = max(1, chips // c)
        load = stats.cols / c * dtype_bytes
        merge = stats.rows / r * dtype_bytes * 2.0  # reduce-scatter ~2x slice
        t = (load + merge) / hw.link_bw
        if t < best_t:
            best_c, best_t = c, t
        c *= 2
    return best_c


def enumerate_schemes(
    stats: MatrixStats,
    hw: HardwareModel,
    dtype_bytes: int = 4,
    include_exotic: bool = False,
) -> list:
    """Plausible candidate Plans for empirical tuning, analytic pick first.

    The :func:`select_scheme` pick, then the format/partitioning/balancing
    alternates the paper's evaluation shows winning on *some* matrix class,
    ranked by :func:`estimate_time`.  ``include_exotic`` adds the 2D
    equally-wide / variable-sized schemes.

    Returns:
      Deduplicated list of Plans; ``[0]`` is always the analytic pick.
    """
    chips = hw.chips
    pick = select_scheme(stats, hw, dtype_bytes)
    fmts = ["coo", "csr"]
    if stats.is_block_pattern or stats.block_fill >= 0.25:
        fmts += ["bcoo", "bcsr"]
    cands = []
    for fmt in fmts:
        balances = ("nnz", "rows") if fmt in ("coo", "bcoo") else ("nnz-rgrn", "rows")
        for balance in balances:
            cands.append(
                Plan("1d", balance, fmt, "ppermute", (chips, 1),
                     f"tuning candidate: 1D {balance} balance, {fmt}")
            )
        if chips > 1:
            cands.append(
                Plan("2d", "equally-sized", fmt, "psum_scatter", (),
                     f"tuning candidate: 2D equally-sized tiles, {fmt}")
            )
            if include_exotic:
                cands.append(
                    Plan("2d", "equally-wide", fmt, "global", (),
                         f"tuning candidate: 2D equally-wide, {fmt}")
                )
                cands.append(
                    Plan("2d", "variable-sized", fmt, "global", (),
                         f"tuning candidate: 2D variable-sized, {fmt}")
                )

    def _key(p: Plan) -> tuple:
        return (p.partitioning, p.scheme, p.fmt, p.merge)

    def _cost(p: Plan) -> float:
        grid = p.grid if p.grid else (chips, 1)
        est = estimate_time(stats, Plan(p.partitioning, p.scheme, p.fmt,
                                        p.merge, grid, p.reason),
                            hw, dtype_bytes)
        return sum(est.values())

    out, seen = [pick], {_key(pick)}
    for p in sorted(cands, key=_cost):
        if _key(p) not in seen:
            seen.add(_key(p))
            out.append(p)
    return out


def estimate_time(
    stats: MatrixStats, plan: Plan, hw: HardwareModel, dtype_bytes: int = 4
) -> dict:
    """Roofline-style napkin estimate of the paper's four steps (Fig. 4)."""
    chips = plan.grid[0] * plan.grid[1]
    flops = 2.0 * stats.nnz / chips
    kernel_bytes = stats.nnz * (dtype_bytes + 8) / chips  # value + 2 indices
    if plan.partitioning == "1d":
        load_bytes = stats.cols * dtype_bytes  # broadcast x (all-gather)
        merge_bytes = dtype_bytes  # one boundary value
    else:
        load_bytes = stats.cols / plan.grid[1] * dtype_bytes
        merge_bytes = stats.rows / plan.grid[0] * dtype_bytes * 2.0
    return {
        "load_s": load_bytes / hw.link_bw,
        "kernel_s": max(flops / hw.peak_flops, kernel_bytes / hw.hbm_bw),
        "merge_s": merge_bytes / hw.link_bw,
    }
