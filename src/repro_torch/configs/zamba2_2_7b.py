"""zamba2-2.7b [arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240, ssm_state=64 — Mamba2 blocks with a
single SHARED attention+MLP block invoked every 6th layer (weight sharing is
the arch's signature). Hybrid: long_500k runs (SSM state + ring-sharded KV
for the shared-attention invocations)."""
from .base import ArchConfig, register


@register("zamba2-2.7b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        head_dim=80,
        tie_embeddings=True,
        ssm_state=64,
        ssm_heads=80,  # d_inner / 64
        ssm_d_inner=5120,
        block_pattern=("mamba",) * 5 + ("shared_attn",),  # 9 repeats
        skip_shapes=(),
        source="arXiv:2411.15242; hf",
    )
