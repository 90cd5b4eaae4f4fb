"""fm [recsys] — factorization machine, O(nk) sum-square trick.
[ICDM'10 (Rendle); paper]
"""
from repro_torch.configs.base import ArchConfig, RecsysConfig, RECSYS_SHAPES

CONFIG = ArchConfig(
    arch_id="fm",
    family="recsys",
    model=RecsysConfig(
        name="fm",
        kind="fm",
        n_sparse=39,
        embed_dim=10,
        interaction="fm-2way",
        rows_per_field=1_000_000,
    ),
    shapes=RECSYS_SHAPES,
    source="ICDM'10 (Rendle)",
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="fm-smoke",
        kind="fm",
        n_sparse=5,
        embed_dim=4,
        interaction="fm-2way",
        rows_per_field=64,
        n_dense=3,
    )
