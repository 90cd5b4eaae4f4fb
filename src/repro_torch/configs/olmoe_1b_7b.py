"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, LMConfig, MoEConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b",
    family="lm",
    model=LMConfig(
        name="olmoe-1b-7b",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024),
    ),
    shapes=LM_SHAPES,
    source="arXiv:2409.02060",
    skip_shapes=("long_500k",),   # full attention (DESIGN.md section 5)
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="olmoe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=256,
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
        attn_block_q=16,
        attn_block_k=16,
    )
