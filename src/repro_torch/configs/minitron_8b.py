"""minitron-8b [dense] — pruned nemotron, 256k vocab. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="minitron-8b",
    family="lm",
    model=LMConfig(
        name="minitron-8b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
        rope_theta=10000.0,
    ),
    shapes=LM_SHAPES,
    source="arXiv:2407.14679",
    skip_shapes=("long_500k",),   # pure full attention (DESIGN.md section 5)
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="minitron-8b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=512,
        rope_theta=10000.0,
        attn_block_q=16,
        attn_block_k=16,
    )
