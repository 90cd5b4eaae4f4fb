"""The paper's own configuration: MeMemo HNSW retrieval (section 5 benchmark).

1M x 384-d vectors, cosine metric, M=5, efConstruction=20 -- the exact
setting behind the paper's "94 minutes in Chrome" construction number.
"""
from repro_torch.configs.base import ArchConfig, RetrievalConfig, ShapeSpec

RETRIEVAL_SHAPES = (
    ShapeSpec("build_1m", "build", {"n_vectors": 1_000_000, "dim": 384}),
    ShapeSpec("query_1m", "retrieval", {"batch": 1024, "n_candidates": 1_000_000,
                                        "dim": 384, "k": 10}),
    ShapeSpec("query_rt", "retrieval", {"batch": 1, "n_candidates": 1_000_000,
                                        "dim": 384, "k": 10}),
)

CONFIG = ArchConfig(
    arch_id="mememo",
    family="retrieval",
    model=RetrievalConfig(
        name="mememo",
        dim=384,
        metric="cosine",
        M=5,
        ef_construction=20,
        ef_search=64,
        n_vectors=1_000_000,
    ),
    shapes=RETRIEVAL_SHAPES,
    source="doi:10.1145/3626772.3657662",
)


def smoke_config() -> RetrievalConfig:
    return RetrievalConfig(
        name="mememo-smoke",
        dim=16,
        metric="cosine",
        M=5,
        ef_construction=20,
        ef_search=24,
        n_vectors=512,
    )


def make_paper_index(kind: str | None = None, **overrides):
    """The paper-configured retriever as a ``VectorIndex`` (any backend)."""
    from repro_torch.core.index import make_index_from_config
    return make_index_from_config(CONFIG.model, kind=kind, **overrides)


def make_smoke_index(kind: str | None = None, **overrides):
    from repro_torch.core.index import make_index_from_config
    return make_index_from_config(smoke_config(), kind=kind, **overrides)
