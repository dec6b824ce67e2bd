"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936 — QKV bias."""
from .base import ArchConfig, register


@register("qwen1.5-0.5b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        head_dim=64,
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        block_pattern=("attn",),
        skip_shapes=("long_500k",),  # pure full attention
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
