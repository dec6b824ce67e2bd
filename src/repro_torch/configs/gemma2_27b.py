"""gemma2-27b [arXiv:2408.00118; hf]
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 —
local+global alternating attention, logit softcapping."""
from .base import ArchConfig, register


@register("gemma2-27b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab=256000,
        head_dim=128,
        rope_theta=10000.0,
        attn_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d/H
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=4096,
        gemma_norm=True,
        tie_embeddings=True,
        block_pattern=("attn_local", "attn_global"),  # 23 repeats
        skip_shapes=("long_500k",),  # global layers are full attention
        source="arXiv:2408.00118; hf",
    )
