"""The mutable retrieval layer: one ``VectorIndex`` protocol for the ANN
backends, ported from ``repro/core/index.py``.

    idx = make_index("hnsw", dim=384, metric="cosine", device="cuda")
    idx.bulk_insert(keys, vectors)
    idx.insert("doc-1", vec)            # single upsert
    idx.update("doc-1", new_vec)        # re-embed in place
    idx.delete("doc-0")                 # retract (tombstone, never returned)
    keys, dists = idx.query(q, k=10)    # ANN search
    keys, dists = idx.query_batch(Q, k) # batched ANN: [B,D] -> lists of lists
    idx.export(path); Idx.load(path)    # one-file persistence (state_dict)
    idx.compact()                       # drop tombstoned rows for real
    idx.mutation_epoch                  # bumped by every mutation (caching)

Keys are caller-owned strings; inserting an existing key is an update;
``delete`` is a soft delete (tombstone); ``size`` counts live keys;
batched queries return lists of lists with ``None`` for missing slots;
every mutation bumps ``mutation_epoch``, which is what lets a result cache
guarantee that a retracted document is never served from a stale entry.

Persistence: the public mutators are template methods — they validate,
write-ahead-log to an attached ``IndexStore`` (``repro_torch.store``),
then call the backend's ``_*_impl``. Backends implement those impls plus
the serialization triple (``config_dict``/``state_dict``/
``restore_state``) that snapshots, WAL replay and the one-file
``export``/``load`` are built on.

All four backends (``flat``, ``ivf``, ``hnsw``, ``tiered``) are ported,
with the store, at any ``n_shards`` (the shards on the devices of
``core/sharded.py:shard_devices``).
"""
from __future__ import annotations

import abc
import json
import os
from typing import Sequence

import numpy as np

_STATE_FORMAT_VERSION = 1
_ARR_PREFIX = "arr_"


class VectorIndex(abc.ABC):
    """Keyed, mutable ANN index."""

    kind: str
    metric: str
    _epoch: int = 0            # mutation counter; instance attr on first bump
    _store = None              # IndexStore when attached (repro_torch.store)

    @property
    def shard_count(self) -> int:
        """Number of shards the corpus is partitioned over (1: the
        single-device layout); key -> shard routing is
        ``core/sharded.py:shard_of_key`` everywhere."""
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

    # --------------------------------------------------- store integration
    def _log_mutation(self, op: str, meta: dict,
                      arrays: dict | None = None) -> None:
        """Append one WAL record BEFORE the mutation touches index state.
        No-op when no store is attached. The record carries the epoch
        *before* the op, which is how replay skips records a snapshot
        already covers. An op that raises AFTER its record landed is
        replayed the same way: the deterministic impl raises identically,
        replay skips the record, and the epoch chain of the following
        records confirms nothing was applied."""
        if self._store is not None:
            self._store.wal_append(op, epoch=self._epoch, meta=meta,
                                   arrays=arrays)

    def _notify_store(self) -> None:
        """After a mutation applied: drive the store's snapshot_every
        policy."""
        if self._store is not None:
            self._store.notify_mutation(self)

    def _apply_derived(self, op: str, meta: dict, arrays: dict) -> None:
        """Replay hook for ``derived.*`` WAL records: state a backend
        trains outside the mutation path that queries depend on (IVF's
        centroids). Backends with such state override this."""
        raise ValueError(f"{type(self).__name__} cannot replay {op!r}")

    # ------------------------------------------------------------ mutation
    # Public mutators are template methods: validate -> WAL -> _*_impl ->
    # notify. Backends implement the _*_impl layer and MUST NOT log or
    # notify there (replay re-enters through the impls).
    def insert(self, key: str, value: Sequence[float]) -> None:
        """Upsert one (key, vector) pair."""
        v = np.asarray(value, np.float32)
        self._log_mutation("insert", {"key": key}, {"vec": v})
        self._insert_impl(key, v)
        self._notify_store()

    def bulk_insert(self, keys: Sequence[str], values) -> None:
        """Batched upsert — ONE WAL record for the whole batch. A key
        repeated WITHIN the batch collapses last-wins before the batch is
        logged or applied."""
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
        self._log_mutation("bulk_insert", {"keys": keys}, {"vec": values})
        self._bulk_insert_impl(keys, values)
        self._notify_store()

    def update(self, key: str, value: Sequence[float]) -> None:
        """Replace the vector of an existing key. KeyError if absent."""
        if not self._contains(key):
            raise KeyError(key)
        v = np.asarray(value, np.float32)
        self._log_mutation("update", {"key": key}, {"vec": v})
        self._update_impl(key, v)
        self._notify_store()

    def delete(self, key: str) -> None:
        """Soft-delete a key: never returned again. KeyError if absent."""
        if not self._contains(key):
            raise KeyError(key)
        self._log_mutation("delete", {"key": key})
        self._delete_impl(key)
        self._notify_store()

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
        """Physically drop tombstoned rows and bump the epoch (so
        epoch-keyed caches invalidate). Compaction is NOT WAL-logged: on
        a store-attached index the store immediately publishes a fresh
        snapshot of the compacted state, truncates the WAL and purges old
        snapshots (secure delete), which also keeps restore sound."""
        self._compact_impl()
        if self._store is not None:
            self._store.on_compact(self)

    @abc.abstractmethod
    def _compact_impl(self) -> None: ...

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

    # --------------------------------------------------------- persistence
    # One serialization triple every backend implements:
    #   config_dict()   -> kwargs that recreate an EMPTY index via
    #                      make_index(self.kind, **cfg)
    #   state_dict()    -> (arrays, meta): full mutation-determined host
    #                      state — rows, tombstones, graph tables, keys,
    #                      epoch, builder RNG state (HNSW)
    #   restore_state() -> inverse of state_dict on a fresh instance
    @abc.abstractmethod
    def config_dict(self) -> dict: ...

    @abc.abstractmethod
    def state_dict(self) -> tuple[dict, dict]: ...

    @abc.abstractmethod
    def restore_state(self, arrays: dict, meta: dict) -> None: ...

    @abc.abstractmethod
    def _row_count(self) -> int:
        """Total rows ever inserted, INCLUDING tombstoned ones."""

    def export(self, path: str) -> None:
        """Write the whole index to one npz (everything ``state_dict``
        captures), atomically."""
        if self._row_count() == 0:
            raise ValueError("index is empty")
        arrays, meta = self.state_dict()
        head = {"format_version": _STATE_FORMAT_VERSION, "kind": self.kind,
                "config": self.config_dict(), "meta": meta}
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:        # file handle: no .npz suffixing
            np.savez(f, __head__=np.frombuffer(json.dumps(head).encode(),
                                               dtype=np.uint8),
                     **{_ARR_PREFIX + k: v for k, v in arrays.items()})
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, *, device=None) -> "VectorIndex":
        """Inverse of :meth:`export`, onto ``device`` (default cuda).
        Returns an instance of the kind the file records."""
        with np.load(path, allow_pickle=False) as z:
            head = json.loads(bytes(z["__head__"]).decode())
            arrays = {k[len(_ARR_PREFIX):]: z[k] for k in z.files
                      if k.startswith(_ARR_PREFIX)}
        idx = make_index(head["kind"], device=device, **head["config"])
        idx.restore_state(arrays, head["meta"])
        return idx

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

_HNSW_KNOBS = ("M", "ef_construction", "ef_search", "beam_impl")


def _construct(kind: str, cfg: dict, device) -> VectorIndex:
    if kind in ("flat", "ivf"):
        for key in _HNSW_KNOBS:
            cfg.pop(key, None)
        if kind == "flat":
            from repro_torch.core.flat import FlatVectorIndex
            return FlatVectorIndex(device=device, **cfg)
        from repro_torch.core.ivf import IVFVectorIndex
        return IVFVectorIndex(device=device, **cfg)
    cfg.pop("dim", None)          # HNSW infers dim from the first insert
    if kind == "tiered":
        from repro_torch.core.tiered import TieredIndex
        return TieredIndex(device=device, **cfg)
    from repro_torch.core.interface import HNSW
    metric = cfg.pop("metric", "cosine")
    return HNSW(distance_function=metric, device=device, **cfg)


def make_index(kind: str, store=None, *, device=None, **cfg) -> VectorIndex:
    """Create a VectorIndex backend by name on ``device`` (default cuda).

    ``cfg`` passes through to the backend constructor (common: metric,
    dim, n_shards, dtype, rerank_factor; hnsw/tiered: M,
    ef_construction, ef_search, seed, use_bulk_build, beam_impl; ivf:
    nlist, nprobe, iters, seed; tiered: cache_rows, prefetch_p).

    store: optional durability home — an ``IndexStore`` or a directory
    path. If the store already holds an index, it is warm-restored onto
    ``device`` (snapshot + WAL replay; the stored construction params win
    over ``cfg``, except ``n_shards``, which reshards on restore; a
    ``kind`` or ``dtype`` mismatch raises). Otherwise
    a fresh index is created and attached, so every mutation from here
    on is write-ahead logged."""
    kind = kind.lower()
    if kind not in INDEX_KINDS:
        raise ValueError(f"unknown index kind {kind!r}; expected one of "
                         f"{INDEX_KINDS}")
    if store is not None:
        from repro_torch.store import IndexStore
        if not isinstance(store, IndexStore):
            store = IndexStore(str(store))
        if store.has_state():
            return store.load_index(expect_kind=kind,
                                    n_shards=cfg.get("n_shards"),
                                    expect_dtype=cfg.get("dtype"),
                                    device=device)
        idx = _construct(kind, cfg, device)
        store.attach(idx)
        return idx
    return _construct(kind, cfg, device)


def make_index_from_config(cfg, kind: str | None = None, store=None,
                           **overrides) -> VectorIndex:
    """Build an index from a ``RetrievalConfig`` (configs/mememo.py)."""
    kind = kind or getattr(cfg, "index_kind", "hnsw")
    if kind == "ivf":
        params = dict(dim=cfg.dim, metric=cfg.metric,
                      nlist=getattr(cfg, "nlist", 64),
                      nprobe=getattr(cfg, "nprobe", 8))
    else:
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
