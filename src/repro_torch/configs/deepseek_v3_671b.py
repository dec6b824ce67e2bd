"""deepseek-v3-671b [arXiv:2412.19437; hf]
61L d_model=7168 128H d_ff(dense prefix)=18432 vocab=129280,
MLA (kv_comp=512, q_comp=1536, rope=64), MoE 1 shared + 256 routed top-8
(expert d_ff=2048), MTP depth 1.  The most SparseP-representative arch:
expert dispatch is a scale-free COO SpMM (DESIGN.md §4)."""
from .base import ArchConfig, register


@register("deepseek-v3-671b")
def cfg() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,  # MLA: latent cache, kv head count unused
        d_ff=18432,  # dense prefix layers
        vocab=129280,
        head_dim=128,
        rope_theta=10000.0,
        tie_embeddings=False,
        use_mla=True,
        mla_kv_comp=512,
        mla_q_comp=1536,
        mla_rope_dim=64,
        n_experts=256,
        moe_top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        moe_router="deepseek",
        mtp_depth=1,
        prefix_pattern=("mla_dense",) * 3,
        block_pattern=("mla_moe",),  # 58 repeats
        skip_shapes=("long_500k",),  # MLA is full attention
        source="arXiv:2412.19437; hf",
    )
