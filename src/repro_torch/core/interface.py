"""MeMemo-parity public API (paper §2.1, Code 1) as a ``VectorIndex``
backend on one device, ported from ``repro/core/interface.py``.

    index = HNSW(distance_function="cosine", M=5, ef_construction=20,
                 device="cuda")
    index.bulk_insert(keys, values)
    index.update("doc-3", new_vec)       # delete + reinsert, same key
    index.delete("doc-7")                # tombstone: excluded from results
    keys, distances = index.query(query, k=10)

Mutation model: the numpy ``SequentialBuilder`` is the canonical mutable
host graph. Deletes are soft (a tombstone mask the search filters on;
deleted ids stay traversable); updates are delete + reinsert under the same
key. The first query uploads a capacity-padded ``DeviceGraph``; later
mutations upload only the builder's dirty-row journal
(``hnsw.apply_row_updates``).

``exact_query``, the recall oracle, scans the builder's live rows with
``FlatIndex`` (the ``distance_topk`` kernel on the card).

This slice serves ``n_shards=1``, ``dtype="fp32"`` and the sequential
builder. Sharding, the lossy codecs and the bulk builder are queued in
ROADMAP.md §1 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw as thnsw
from repro_torch.core import hnsw_build as build
from repro_torch.core.codec import get_codec
from repro_torch.core.flat import FlatIndex
from repro_torch.core.index import VectorIndex
from repro_torch.utils import resolve_device


class HNSW(VectorIndex):
    kind = "hnsw"

    def __init__(self, distance_function: str = "cosine", *, M: int = 16,
                 ef_construction: int = 200, ef_search: int = 64,
                 seed: int = 0, use_bulk_build: bool = False,
                 n_shards: int = 1, dtype: str = "fp32",
                 rerank_factor: int | None = None,
                 beam_impl: str = "fused", device=None):
        if distance_function not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown distanceFunction {distance_function!r}")
        if beam_impl not in ("fused", "jnp"):
            raise ValueError(f"unknown beam_impl {beam_impl!r}; "
                             "expected 'fused' or 'jnp'")
        if int(n_shards) != 1:
            raise NotImplementedError(
                "n_shards > 1 is not ported yet (ROADMAP.md §1: multi-GPU)")
        # rows are fp32, whose search distances are exact: rerank_factor
        # never applies
        self.dtype = get_codec(dtype).name
        if self.dtype != "fp32":
            raise NotImplementedError(
                f"HNSW with dtype={self.dtype!r} is not ported yet (ROADMAP.md"
                " §1: bf16/int8 variants of gather_distance and beam_search "
                "plus the lossy ingest and rerank of core/interface.py)")
        if use_bulk_build:
            raise NotImplementedError(
                "use_bulk_build is not ported yet (ROADMAP.md §1: bulk_build "
                "with select_neighbors)")
        self.device = resolve_device(device)
        self.metric = distance_function
        # layer-0 beam: "fused" is one kernel launch; "jnp" the per-hop loop
        self.beam_impl = beam_impl
        self.M = M
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.seed = seed
        self._keys: list[str] = []               # node id -> key
        self._key2id: dict[str, int] = {}        # live keys only
        self._deleted = np.zeros(0, bool)        # tombstones, capacity-sized
        self._builder: build.SequentialBuilder | None = None
        self._device_graph: thnsw.DeviceGraph | None = None
        self._deleted_dirty = False

    # ------------------------------------------------------------ mutation
    def _insert_impl(self, key: str, value: np.ndarray) -> None:
        """Upsert one (key, vector); existing keys are updated in place."""
        if key in self._key2id:
            self._delete_impl(key)
        v = np.asarray(value, np.float32)
        if self._builder is None:
            self._builder = build.SequentialBuilder(
                v.shape[-1], M=self.M, ef_construction=self.ef_construction,
                metric=self.metric, seed=self.seed)
        node = self._builder.insert(v)
        if node != len(self._keys):
            raise RuntimeError("builder node ids out of step with the keys")
        self._keys.append(key)
        self._key2id[key] = node
        self._bump_epoch()

    bulkInsert = VectorIndex.bulk_insert   # TS-parity alias

    def _update_impl(self, key: str, value: np.ndarray) -> None:
        """Replace the vector of an existing key (delete + reinsert)."""
        self._insert_impl(key, value)

    def _delete_impl(self, key: str) -> None:
        """Soft-delete: tombstone the row; it stays traversable but is
        never returned again."""
        node = self._key2id.pop(key)               # KeyError if absent
        self._ensure_tombstones()
        self._deleted[node] = True
        self._deleted_dirty = True
        self._bump_epoch()

    def _ensure_tombstones(self):
        cap = self._builder.vectors.shape[0] if self._builder is not None else 0
        if self._deleted.shape[0] < cap:
            pad = np.zeros(cap - self._deleted.shape[0], bool)
            self._deleted = np.concatenate([self._deleted, pad])

    # ----------------------------------------------------- device residency
    def _dg(self) -> thnsw.DeviceGraph:
        """Resident device graph, synced incrementally when possible."""
        if self._builder is None:
            raise ValueError("index is empty")
        b = self._builder
        self._ensure_tombstones()
        g = b.graph_full_capacity(b.max_level_cap)   # fixed [12, cap, M] upper
        dg = self._device_graph
        if dg is None or tuple(dg.vectors.shape) != g.vectors.shape:
            # first upload, or capacity growth: full conversion
            self._device_graph = thnsw.to_device_graph(
                g, self._deleted, device=self.device)
            b.journal.clear()
            self._deleted_dirty = False
        elif b.journal or self._deleted_dirty or dg.max_level != g.max_level:
            # incremental: only dirty rows travel to the device
            self._device_graph = thnsw.apply_row_updates(
                dg, g, b.journal,
                self._deleted if self._deleted_dirty else None)
            b.journal.clear()
            self._deleted_dirty = False
        return self._device_graph

    def host_graph(self) -> build.HNSWGraph:
        """The capacity view of the host graph the device graph mirrors."""
        if self._builder is None:
            raise ValueError("index is empty")
        return self._builder.graph_full_capacity(self._builder.max_level_cap)

    # --------------------------------------------------------------- query
    def query_batch(self, queries, k: int = 10, ef: int | None = None):
        """One lock-step device search for the whole [B, D] batch."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        # fp32 rows: the beam's distances are exact, so nothing reranks
        ids, dists = thnsw.search_graph(self._dg(), q, k=k,
                                        ef=ef or self.ef_search,
                                        beam_impl=self.beam_impl)
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        keys = [[self._keys[i] if i >= 0 else None for i in row] for row in ids]
        return keys, dists

    def exact_query(self, query, k: int = 10):
        """Brute-force oracle over the same LIVE rows -> (keys, dists),
        ``min(k, live)`` columns: a ``FlatIndex`` over the builder's rows
        (already normalized for cosine) on the index's device."""
        if self._builder is None:
            raise ValueError("index is empty")
        self._ensure_tombstones()
        n = self._builder.n
        live = np.flatnonzero(~self._deleted[:n])
        if live.size == 0:
            raise ValueError("index is empty")
        flat = FlatIndex(vectors=torch.as_tensor(self._builder.vectors[live],
                                                 device=self.device),
                         metric=self.metric)
        q = np.asarray(query, np.float32)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None]
        d, i = flat.query(q, min(k, live.size))
        d, i = d.cpu().numpy(), i.cpu().numpy()
        keys = [[self._keys[int(live[j])] for j in row] for row in i]
        if squeeze:
            return keys[0], d[0]
        return keys, d

    @property
    def size(self) -> int:
        return len(self._key2id)

    def _contains(self, key: str) -> bool:
        return key in self._key2id

    def _row_count(self) -> int:
        return self._builder.n if self._builder is not None else 0

    def keys(self) -> list[str]:
        n = self._row_count()
        self._ensure_tombstones()
        return [self._keys[i] for i in range(n) if not self._deleted[i]]
