"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="llama3-8b",
    family="lm",
    model=LMConfig(
        name="llama3-8b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        rope_theta=500000.0,
    ),
    shapes=LM_SHAPES,
    source="arXiv:2407.21783",
    # pure full attention: long_500k mandated skip (DESIGN.md section 5)
    skip_shapes=("long_500k",),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama3-8b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rope_theta=500000.0,
        attn_block_q=16,
        attn_block_k=16,
    )
