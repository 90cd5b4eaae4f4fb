"""The mutable retrieval layer: one ``VectorIndex`` protocol for the ANN
backends, ported from ``repro/core/index.py``.

    idx = make_index("hnsw", dim=384, metric="cosine", device="cuda")
    idx.bulk_insert(keys, vectors)
    idx.insert("doc-1", vec)            # single upsert
    idx.update("doc-1", new_vec)        # re-embed in place
    idx.delete("doc-0")                 # retract (tombstone, never returned)
    keys, dists = idx.query(q, k=10)    # ANN search
    keys, dists = idx.query_batch(Q, k) # batched ANN: [B,D] -> lists of lists
    idx.mutation_epoch                  # bumped by every mutation (caching)

Keys are caller-owned strings; inserting an existing key is an update;
``delete`` is a soft delete (tombstone); ``size`` counts live keys;
batched queries return lists of lists with ``None`` for missing slots;
every mutation bumps ``mutation_epoch``, which is what lets a result cache
guarantee that a retracted document is never served from a stale entry.

The ``flat`` and ``hnsw`` backends are ported, on one device and with no
store attached. ``ivf``/``tiered``, the durable store (WAL, snapshots,
warm restore), ``state_dict``/``restore_state``, export/load and
``compact`` are queued in ROADMAP.md §1 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class VectorIndex(abc.ABC):
    """Keyed, mutable ANN index."""

    kind: str
    metric: str
    _epoch: int = 0            # mutation counter; instance attr on first bump

    @property
    def shard_count(self) -> int:
        """Number of shards the corpus is partitioned over (1: one
        device)."""
        return 1

    @property
    def storage_dtype(self) -> str:
        """Row-storage codec name: "fp32" | "bf16" | "int8". Backends that
        accept ``dtype=`` set it; the serving layer only logs it."""
        return getattr(self, "dtype", "fp32")

    @property
    def mutation_epoch(self) -> int:
        """Monotonic counter bumped by every insert/update/delete; caches
        of query results key their validity on it."""
        return self._epoch

    def _bump_epoch(self) -> None:
        self._epoch = self._epoch + 1

    # ------------------------------------------------------------ mutation
    # Public mutators are template methods: validate -> _*_impl. (The
    # reference writes a WAL record in between; the store is not ported.)
    def insert(self, key: str, value: Sequence[float]) -> None:
        """Upsert one (key, vector) pair."""
        self._insert_impl(key, np.asarray(value, np.float32))

    def bulk_insert(self, keys: Sequence[str], values) -> None:
        """Batched upsert. A key repeated WITHIN the batch collapses
        last-wins before the batch is applied."""
        values = np.asarray(values, np.float32)
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        keys = list(keys)
        if len(set(keys)) != len(keys):
            last: dict = {}
            for i, k in enumerate(keys):
                last[k] = i
            keep = sorted(last.values())
            keys = [keys[i] for i in keep]
            values = values[keep]
        self._bulk_insert_impl(keys, values)

    def update(self, key: str, value: Sequence[float]) -> None:
        """Replace the vector of an existing key. KeyError if absent."""
        if not self._contains(key):
            raise KeyError(key)
        self._update_impl(key, np.asarray(value, np.float32))

    def delete(self, key: str) -> None:
        """Soft-delete a key: never returned again. KeyError if absent."""
        if not self._contains(key):
            raise KeyError(key)
        self._delete_impl(key)

    @abc.abstractmethod
    def _insert_impl(self, key: str, value: np.ndarray) -> None: ...

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
        for k, v in zip(keys, values):
            self._insert_impl(k, v)

    @abc.abstractmethod
    def _update_impl(self, key: str, value: np.ndarray) -> None: ...

    @abc.abstractmethod
    def _delete_impl(self, key: str) -> None: ...

    def compact(self) -> None:
        raise NotImplementedError(
            "compact is not ported yet (ROADMAP.md §1: store/warm restore)")

    def export(self, path: str) -> None:
        raise NotImplementedError(
            "export/load is not ported yet (ROADMAP.md §1: store/warm "
            "restore)")

    def state_dict(self):
        raise NotImplementedError(
            "state_dict is not ported yet (ROADMAP.md §1: store/warm "
            "restore)")

    def restore_state(self, arrays: dict, meta: dict) -> None:
        raise NotImplementedError(
            "restore_state is not ported yet (ROADMAP.md §1: store/warm "
            "restore)")

    # --------------------------------------------------------------- query
    def query(self, query, k: int = 10, **kw):
        """ANN top-k -> (keys, dists); a 1-D query returns one row, a
        [B, D] batch returns lists of lists."""
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            keys, d = self.query_batch(q[None], k, **kw)
            return keys[0], d[0]
        return self.query_batch(q, k, **kw)

    @abc.abstractmethod
    def query_batch(self, queries, k: int = 10, **kw):
        """Batched ANN search: queries [B, D] -> (keys, dists) where keys
        is a list of B lists of k key-or-None and dists is [B, k]."""

    @abc.abstractmethod
    def exact_query(self, query, k: int = 10):
        """Brute-force top-k over the same live rows -> (keys, dists)."""

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of live (non-deleted) keys."""

    def __len__(self) -> int:
        return self.size

    @abc.abstractmethod
    def _contains(self, key: str) -> bool: ...

    def __contains__(self, key: str) -> bool:
        return self._contains(key)

    @abc.abstractmethod
    def keys(self) -> list[str]:
        """Live keys, in insertion order."""


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------
INDEX_KINDS = ("flat", "ivf", "hnsw", "tiered")

_KIND_ITEMS = {"ivf": "IVF/tiered", "tiered": "IVF/tiered"}


def make_index(kind: str, store=None, *, device=None, **cfg) -> VectorIndex:
    """Create a VectorIndex backend by name on ``device`` (default cuda).

    ``flat`` and ``hnsw`` without a store are ported; ``cfg`` passes
    through to the backend constructor (common: metric, dim, n_shards,
    dtype, rerank_factor; hnsw: M, ef_construction, ef_search, seed,
    use_bulk_build, beam_impl)."""
    kind = kind.lower()
    if kind not in INDEX_KINDS:
        raise ValueError(f"unknown index kind {kind!r}; expected one of "
                         f"{INDEX_KINDS}")
    if kind in _KIND_ITEMS:
        raise NotImplementedError(
            f"index kind {kind!r} is not ported yet (ROADMAP.md §1: "
            f"{_KIND_ITEMS[kind]})")
    if store is not None:
        raise NotImplementedError(
            "a durable index store is not ported yet (ROADMAP.md §1: "
            "store/warm restore)")
    if kind == "flat":
        from repro_torch.core.flat import FlatVectorIndex
        for key in ("M", "ef_construction", "ef_search", "beam_impl"):
            cfg.pop(key, None)
        return FlatVectorIndex(device=device, **cfg)
    from repro_torch.core.interface import HNSW
    cfg.pop("dim", None)          # HNSW infers dim from the first insert
    metric = cfg.pop("metric", "cosine")
    return HNSW(distance_function=metric, device=device, **cfg)


def make_index_from_config(cfg, kind: str | None = None, store=None,
                           **overrides) -> VectorIndex:
    """Build an index from a ``RetrievalConfig`` (configs/mememo.py)."""
    kind = kind or getattr(cfg, "index_kind", "hnsw")
    params = dict(dim=cfg.dim, metric=cfg.metric, M=cfg.M,
                  ef_construction=cfg.ef_construction,
                  ef_search=cfg.ef_search)
    for name, key in (("n_shards", "n_shards"), ("index_dtype", "dtype"),
                      ("beam_impl", "beam_impl")):
        val = getattr(cfg, name, None)
        if val is not None:
            params[key] = val
    params.update(overrides)
    return make_index(kind, store=store, **params)
