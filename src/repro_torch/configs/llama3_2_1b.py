"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified]
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256 — small llama3."""
from .base import ArchConfig, register


@register("llama3.2-1b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        head_dim=64,
        rope_theta=500000.0,
        tie_embeddings=True,
        block_pattern=("attn",),
        skip_shapes=("long_500k",),  # pure full attention (DESIGN.md §4)
        source="hf:meta-llama/Llama-3.2-1B; unverified",
    )
