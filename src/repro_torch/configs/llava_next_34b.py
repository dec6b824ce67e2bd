"""llava-next-34b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — anyres tiling.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (2880 prefix tokens = 5 anyres tiles x 576 patches)."""
from .base import ArchConfig, register


@register("llava-next-34b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        rope_theta=1000000.0,
        tie_embeddings=False,
        block_pattern=("attn",),
        modality_tokens=2880,
        skip_shapes=("long_500k",),  # pure full attention
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )
