"""seamless-m4t-medium [arXiv:2308.11596; hf]
12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Enc-dec, multimodal: the speech frontend is a STUB — input_specs() provides
precomputed frame embeddings (system-prompt requirement)."""
from .base import ArchConfig, register


@register("seamless-m4t-medium")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,  # decoder layers
        encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        head_dim=64,
        tie_embeddings=True,
        block_pattern=("cross_attn",),  # decoder: self + cross + mlp
        modality_tokens=0,  # encoder consumes frames directly
        skip_shapes=("long_500k",),  # full attention
        source="arXiv:2308.11596; hf",
    )
