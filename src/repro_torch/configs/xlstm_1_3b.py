"""xlstm-1.3b [arXiv:2405.04517; unverified]
48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks at 1:7
(the paper's xLSTM[7:1] stack). Attention-free: long_500k runs with O(1)
recurrent state; SparseP applies only to projections (DESIGN.md §4)."""
from .base import ArchConfig, register


@register("xlstm-1.3b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        head_dim=512,
        tie_embeddings=True,
        block_pattern=("mlstm",) * 7 + ("slstm",),  # 6 repeats
        skip_shapes=(),
        source="arXiv:2405.04517; unverified",
    )
