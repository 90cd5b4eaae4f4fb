"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA. [arXiv:2401.16818; unverified]

The sliding-window attention makes this the designated sub-quadratic
long-context arch: the only LM that runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="h2o-danube-3-4b",
    family="lm",
    model=LMConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab=32000,
        rope_theta=10000.0,
        sliding_window=4096,          # mistral-style SWA
    ),
    shapes=LM_SHAPES,
    source="arXiv:2401.16818",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="h2o-danube-3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rope_theta=10000.0,
        sliding_window=32,
        attn_block_q=16,
        attn_block_k=16,
    )
