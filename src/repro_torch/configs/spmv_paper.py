"""The paper's own workload config: distributed SpMV over the matrix suites.

Counterpart of ``repro/configs/spmv_paper.py``, over the port's copy of the
synthetic matrices (``repro_torch.data.matrices``).  Not an LM
architecture: it names the paper's evaluation axes and its two suites.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data import MatrixSpec, paper_large_suite, paper_small_suite

__all__ = ["SpmvPaperConfig", "spmv_paper_config"]


@dataclass(frozen=True)
class SpmvPaperConfig:
    name: str = "spmv-paper"
    # evaluation axes, straight from the paper
    formats: tuple = ("csr", "coo", "bcsr", "bcoo")
    balance_1d: tuple = ("rows", "nnz-rgrn", "nnz")
    schemes_2d: tuple = ("equally-sized", "equally-wide", "variable-sized")
    dtypes: tuple = ("int8", "int32", "bfloat16", "float32")
    vertical_partitions: tuple = (1, 2, 4, 8, 16, 32)
    block: tuple = (8, 128)  # TPU-native (paper used 4x4)
    # mesh points mirroring the paper's DPU sweeps
    core_counts: tuple = (64, 256, 1024, 2528)

    def small_suite(self, scale: int = 1) -> list[MatrixSpec]:
        return paper_small_suite(scale)

    def large_suite(self, scale: int = 1) -> list[MatrixSpec]:
        return paper_large_suite(scale)


def spmv_paper_config() -> SpmvPaperConfig:
    return SpmvPaperConfig()
