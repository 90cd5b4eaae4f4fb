"""Retrieval core: codec, HNSW builder and search, the VectorIndex layer."""
