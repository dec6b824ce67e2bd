"""smollm-360m [hf:HuggingFaceTB/SmolLM-135M; hf]
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 — llama-arch small."""
from .base import ArchConfig, register


@register("smollm-360m")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab=49152,
        head_dim=64,
        rope_theta=10000.0,
        tie_embeddings=True,
        block_pattern=("attn",),
        skip_shapes=("long_500k",),  # pure full attention
        source="hf:HuggingFaceTB/SmolLM-135M; hf",
    )
