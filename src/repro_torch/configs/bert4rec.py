"""bert4rec [recsys] — bidirectional sequence encoder. [arXiv:1904.06690; paper]"""
from repro_torch.configs.base import ArchConfig, RecsysConfig, RECSYS_SHAPES

CONFIG = ArchConfig(
    arch_id="bert4rec",
    family="recsys",
    model=RecsysConfig(
        name="bert4rec",
        kind="bert4rec",
        embed_dim=64,
        n_blocks=2,
        n_heads=2,
        seq_len=200,
        interaction="bidir-seq",
        n_items=60_000,
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1904.06690",
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="bert4rec-smoke",
        kind="bert4rec",
        embed_dim=16,
        n_blocks=2,
        n_heads=2,
        seq_len=20,
        interaction="bidir-seq",
        n_items=300,
    )
