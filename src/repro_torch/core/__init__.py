"""Retrieval core: codec, HNSW builder and search, the VectorIndex layer,
and the multi-tenant ``IndexPool`` (``core/tenancy.py``)."""
from repro_torch.core.tenancy import IndexPool

__all__ = ["IndexPool"]
