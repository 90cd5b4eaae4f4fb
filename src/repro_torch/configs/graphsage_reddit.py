"""graphsage-reddit [gnn] — 2 layers, mean agg, fanout 25-10. [arXiv:1706.02216; paper]"""
from repro_torch.configs.base import ArchConfig, GNNConfig, GNN_SHAPES

CONFIG = ArchConfig(
    arch_id="graphsage-reddit",
    family="gnn",
    model=GNNConfig(
        name="graphsage-reddit",
        n_layers=2,
        d_hidden=128,
        aggregator="mean",
        sample_sizes=(25, 10),
    ),
    shapes=GNN_SHAPES,
    source="arXiv:1706.02216",
)


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="graphsage-smoke",
        n_layers=2,
        d_hidden=16,
        aggregator="mean",
        sample_sizes=(5, 3),
    )
