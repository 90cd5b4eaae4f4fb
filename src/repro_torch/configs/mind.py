"""mind [recsys] — multi-interest capsule routing. [arXiv:1904.08030; unverified]"""
from repro_torch.configs.base import ArchConfig, RecsysConfig, RECSYS_SHAPES

CONFIG = ArchConfig(
    arch_id="mind",
    family="recsys",
    model=RecsysConfig(
        name="mind",
        kind="mind",
        embed_dim=64,
        n_interests=4,
        capsule_iters=3,
        interaction="multi-interest",
        seq_len=50,
        n_items=1_000_000,
        mlp_dims=(256, 64),
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1904.08030",
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="mind-smoke",
        kind="mind",
        embed_dim=16,
        n_interests=2,
        capsule_iters=2,
        interaction="multi-interest",
        seq_len=10,
        n_items=500,
        mlp_dims=(32, 16),
    )
