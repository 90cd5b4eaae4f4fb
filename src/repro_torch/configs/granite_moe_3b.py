"""granite-moe-3b-a800m [moe] — MoE 40e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, LMConfig, MoEConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="granite-moe-3b-a800m",
    family="lm",
    model=LMConfig(
        name="granite-moe-3b-a800m",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        head_dim=64,
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
        tie_embeddings=True,
    ),
    shapes=LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    skip_shapes=("long_500k",),   # full attention (DESIGN.md section 5)
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-moe-smoke",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab=256,
        head_dim=12,
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=5, top_k=2, d_ff=32),
        tie_embeddings=True,
        attn_block_q=16,
        attn_block_k=16,
    )
