"""wide-deep [recsys] — wide linear + deep MLP. [arXiv:1606.07792; paper]"""
from repro_torch.configs.base import ArchConfig, RecsysConfig, RECSYS_SHAPES

CONFIG = ArchConfig(
    arch_id="wide-deep",
    family="recsys",
    model=RecsysConfig(
        name="wide-deep",
        kind="wide_deep",
        n_sparse=40,
        embed_dim=32,
        mlp_dims=(1024, 512, 256),
        interaction="concat",
        rows_per_field=1_000_000,
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1606.07792",
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="wide-deep-smoke",
        kind="wide_deep",
        n_sparse=6,
        embed_dim=8,
        mlp_dims=(32, 16),
        interaction="concat",
        rows_per_field=100,
        n_dense=4,
    )
