"""mixtral-8x22b [arXiv:2401.04088; hf]
56L d_model=6144 48H (GQA kv=8) MoE 8 experts top-2 (expert d_ff=16384),
sliding-window attention — SWA makes long_500k decode window-bounded."""
from .base import ArchConfig, register


@register("mixtral-8x22b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        head_dim=128,
        rope_theta=1000000.0,
        tie_embeddings=False,
        sliding_window=4096,
        n_experts=8,
        moe_top_k=2,
        moe_d_ff=16384,
        moe_router="mixtral",
        block_pattern=("moe",),
        skip_shapes=(),  # SWA: long_500k runs with a window-sized KV cache
        source="arXiv:2401.04088; hf",
    )
