"""Synthetic sparse-matrix generators matching the paper's dataset classes.

Counterpart of ``repro/data/matrices.py``, kept as a copy because the port
never imports the JAX package: pure numpy, the same seeds and the same draws,
so every generator gives the reference's arrays element for element.

The evaluation matrices (paper Tables 3/4/8) come from SuiteSparse, which is
unavailable offline — we generate synthetic matrices that reproduce the three
statistical classes the paper's analysis keys on:

  * regular      — low NNZ-r-std (meshes/roads: hugetric, mc2depi, roadNet…);
                   generated as banded + jittered-diagonal matrices.
  * scale-free   — NNZ-r-std > 25 with power-law row degrees (web/social:
                   in-2004, com-Youtube, sx-stackoverflow…); generated with
                   Zipf row degrees + preferential column attachment.
  * block        — nonzeros clustered in dense r x c blocks (FEM: raefsky4,
                   pkustk08, ldoor, boneS10…); generated as random dense
                   block grids ((8, 16) blocks by default).

``paper_small_suite`` / ``paper_large_suite`` mirror Table 3 / Table 4 rows
(scaled down; same class + comparable sparsity and NNZ-r-std ordering), so
every benchmark iterates "the 26 matrices" faithfully in miniature.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "regular_matrix",
    "scale_free_matrix",
    "block_matrix",
    "paper_small_suite",
    "paper_large_suite",
    "MatrixSpec",
]


def regular_matrix(rows: int, cols: int, nnz_per_row: int = 5, seed: int = 0,
                   dtype=np.float32) -> np.ndarray:
    """Banded matrix with jitter: near-constant row degree (NNZ-r-std << 1)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((rows, cols), dtype)
    band = max(1, cols // 16)
    for r in range(rows):
        center = int(r * cols / rows)
        offs = rng.integers(-band, band + 1, nnz_per_row)
        cs = np.clip(center + offs, 0, cols - 1)
        a[r, cs] = rng.standard_normal(len(cs)).astype(dtype)
    return a


def scale_free_matrix(rows: int, cols: int, nnz_target: int, seed: int = 0,
                      alpha: float = 1.6, dtype=np.float32) -> np.ndarray:
    """Power-law row degrees + preferential column attachment.

    Produces the paper's scale-free pathologies: a few very dense rows
    (CSR.nnz row-granularity imbalance, Obs. 4) and hub columns
    (irregular x-access locality)."""
    rng = np.random.default_rng(seed)
    # Zipf row degrees normalized to nnz_target
    ranks = np.arange(1, rows + 1, dtype=np.float64)
    deg = ranks ** (-alpha)
    deg = np.maximum(1, np.round(deg / deg.sum() * nnz_target)).astype(np.int64)
    rng.shuffle(deg)
    # hub columns: Zipf column popularity
    col_p = (np.arange(1, cols + 1, dtype=np.float64)) ** (-alpha)
    col_p /= col_p.sum()
    col_ids = rng.permutation(cols)
    a = np.zeros((rows, cols), dtype)
    for r in range(rows):
        k = min(int(deg[r]), cols)
        cs = col_ids[rng.choice(cols, k, replace=False, p=col_p)]
        a[r, cs] = rng.standard_normal(k).astype(dtype)
    return a


def block_matrix(rows: int, cols: int, block=(8, 16), block_density=0.08,
                 seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Dense r x c blocks on a sparse block grid (block_fill ~ 1.0)."""
    rng = np.random.default_rng(seed)
    r, c = block
    assert rows % r == 0 and cols % c == 0
    mask = rng.random((rows // r, cols // c)) < block_density
    a = np.kron(mask, np.ones((r, c))).astype(dtype)
    return a * rng.standard_normal((rows, cols)).astype(dtype)


@dataclass(frozen=True)
class MatrixSpec:
    name: str  # paper matrix it mirrors
    cls: str  # regular | scale-free | block
    rows: int
    cols: int
    nnz_per_row: int = 5
    block_density: float = 0.08
    seed: int = 0

    def build(self, dtype=np.float32) -> np.ndarray:
        if self.cls == "regular":
            return regular_matrix(self.rows, self.cols, self.nnz_per_row,
                                  self.seed, dtype)
        if self.cls == "scale-free":
            return scale_free_matrix(self.rows, self.cols,
                                     self.rows * self.nnz_per_row, self.seed,
                                     dtype=dtype)
        if self.cls == "block":
            return block_matrix(self.rows, self.cols,
                                block_density=self.block_density,
                                seed=self.seed, dtype=dtype)
        raise ValueError(self.cls)


def paper_small_suite(scale: int = 1) -> list[MatrixSpec]:
    """Table 3 miniature: delaunay_n13, wing_nodal (regular-ish);
    raefsky4, pkustk08 (block)."""
    s = scale
    return [
        MatrixSpec("delaunay_n13", "regular", 1024 * s, 1024 * s, 3, seed=13),
        MatrixSpec("wing_nodal", "regular", 1024 * s, 1024 * s, 7, seed=7),
        MatrixSpec("raefsky4", "block", 1024 * s, 1024 * s, block_density=0.12, seed=4),
        MatrixSpec("pkustk08", "block", 1024 * s, 1024 * s, block_density=0.2, seed=8),
    ]


def paper_large_suite(scale: int = 1) -> list[MatrixSpec]:
    """Table 4 miniature: ordered by NNZ-r-std like the paper (regular ->
    scale-free), with the block-pattern entries marked by class."""
    s = scale
    return [
        MatrixSpec("hugetric-00020", "regular", 2048 * s, 2048 * s, 3, seed=1),
        MatrixSpec("mc2depi", "regular", 2048 * s, 2048 * s, 4, seed=2),
        MatrixSpec("parabolic_fem", "regular", 2048 * s, 2048 * s, 7, seed=3),
        MatrixSpec("roadNet-TX", "regular", 2048 * s, 2048 * s, 3, seed=4),
        MatrixSpec("rajat31", "regular", 2048 * s, 2048 * s, 4, seed=5),
        MatrixSpec("af_shell1", "block", 2048 * s, 2048 * s,
                   block_density=0.15, seed=6),
        MatrixSpec("delaunay_n19", "regular", 2048 * s, 2048 * s, 6, seed=7),
        MatrixSpec("thermomech_dK", "regular", 2048 * s, 2048 * s, 14, seed=8),
        MatrixSpec("memchip", "regular", 2048 * s, 2048 * s, 5, seed=9),
        MatrixSpec("amazon0601", "scale-free", 2048 * s, 2048 * s, 8, seed=10),
        MatrixSpec("FEM_3D_thermal2", "regular", 2048 * s, 2048 * s, 23, seed=11),
        MatrixSpec("web-Google", "scale-free", 2048 * s, 2048 * s, 6, seed=12),
        MatrixSpec("ldoor", "block", 2048 * s, 2048 * s, block_density=0.3, seed=13),
        MatrixSpec("poisson3Db", "regular", 2048 * s, 2048 * s, 27, seed=14),
        MatrixSpec("boneS10", "block", 2048 * s, 2048 * s, block_density=0.4, seed=15),
        MatrixSpec("webbase-1M", "scale-free", 2048 * s, 2048 * s, 3, seed=16),
        MatrixSpec("in-2004", "scale-free", 2048 * s, 2048 * s, 12, seed=17),
        MatrixSpec("pkustk14", "block", 2048 * s, 2048 * s, block_density=0.5, seed=18),
        MatrixSpec("com-Youtube", "scale-free", 2048 * s, 2048 * s, 5, seed=19),
        MatrixSpec("as-Skitter", "scale-free", 2048 * s, 2048 * s, 13, seed=20),
        MatrixSpec("sx-stackoverflow", "scale-free", 2048 * s, 2048 * s, 14, seed=21),
        MatrixSpec("ASIC_680k", "scale-free", 2048 * s, 2048 * s, 6, seed=22),
    ]
