"""Two-tier memory model with graph-aware prefetching — MeMemo §3.2,
ported from ``repro/core/tiered.py`` (host numpy in both packages, so a
search over the same graph gives the same results and counts bit for
bit).

The paper's mechanism: vectors live in a slow bulk tier (IndexedDB), RAM
keeps only keys + graph topology + a cache of ``p`` vectors; on a cache
miss the store prefetches ``p`` *graph neighbors on the current layer* of
the missed element in ONE bulk transaction. ``p`` is derived from the
vector dimension (a byte budget a transaction).

``TieredIndex`` is the queryable version: its mutations go to an inner
``HNSW`` on the index's device, and its searches run the host beam through
the two-tier store, counting slow-tier transactions, hits and misses
(``TierStats``). ``exact_query`` is the inner index's (``distance_topk``
on the card).

At ``n_shards > 1`` the inner index is the sharded HNSW: ``query_batch``
is its device fan-out over the children's graphs (``core/stacked.py``),
and the host loop over per-shard tiers, one ``TieredVectorStore`` a
shard, stays as ``_query_batch_sharded_loop``: the accounting model of
sharded traffic and the fan-out's parity oracle.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.hnsw_build import HNSWGraph, _dist
from repro_torch.core.index import VectorIndex

# the fast tier grants a fixed byte budget a transaction (1 MiB)
PREFETCH_BYTE_BUDGET = 1 << 20


def auto_prefetch_p(dim: int, itemsize: int = 4) -> int:
    return max(1, PREFETCH_BYTE_BUDGET // (dim * itemsize))


@dataclasses.dataclass
class TierStats:
    transactions: int = 0          # slow-tier bulk reads
    rows_fetched: int = 0          # rows moved slow -> fast
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        total = max(self.hits + self.misses, 1)
        return {**dataclasses.asdict(self), "hit_rate": self.hits / total}


class TieredVectorStore:
    """Slow tier: the full row array. Fast tier: an LRU cache of
    ``cache_rows`` rows.

    ``read(ids, neighbor_fn)``: each requested row that misses triggers ONE
    transaction fetching it and up to ``p - 1`` of its current-layer graph
    neighbors (the paper's policy); without neighbor info, the next ``p``
    rows in order.

    A lossy ``codec`` makes the slow tier hold the encoded rows (+ scales)
    and ``read`` decode on admission, so the fast tier serves fp32 rows.
    The prefetch budget is in bytes, so an int8 slow tier prefetches ~4x
    more neighbors a transaction.
    """

    def __init__(self, vectors: np.ndarray, *, cache_rows: int,
                 prefetch_p: int | None = None, codec=None):
        self.codec = codec if (codec is not None and codec.lossy) else None
        if self.codec is not None:
            self.slow, self._slow_scales = self.codec.encode(
                np.asarray(vectors, np.float32))
            itemsize = self.codec.enc_dtype.itemsize
        else:
            self.slow = vectors
            self._slow_scales = None
            itemsize = vectors.itemsize
        self.dim = vectors.shape[1]
        self.p = prefetch_p or auto_prefetch_p(self.dim, itemsize)
        self.cache_rows = max(cache_rows, self.p)
        self.cache: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self.stats = TierStats()

    @property
    def slow_tier_bytes(self) -> int:
        """Bytes the slow tier holds (encoded under a codec)."""
        total = self.slow.nbytes
        if self._slow_scales is not None:
            total += self._slow_scales.nbytes
        return total

    def _slow_row(self, i: int) -> np.ndarray:
        if self.codec is None:
            return self.slow[i]
        return self.codec.decode(self.slow[i][None],
                                 self._slow_scales[i:i + 1]
                                 if self._slow_scales is not None
                                 else None)[0]

    def _admit(self, row_id: int, row: np.ndarray):
        if row_id in self.cache:
            self.cache.move_to_end(row_id)
            return
        if len(self.cache) >= self.cache_rows:
            self.cache.popitem(last=False)
            self.stats.evictions += 1
        self.cache[row_id] = row

    def _transaction(self, ids: list[int]):
        """One slow-tier bulk read of len(ids) rows."""
        self.stats.transactions += 1
        self.stats.rows_fetched += len(ids)
        for i in ids:
            self._admit(i, self._slow_row(i))

    def read(self, ids, neighbor_fn=None) -> np.ndarray:
        """Rows by id (fp32-decoded under a codec); ``neighbor_fn(id) ->
        iterable`` gives the current-layer graph neighbors to prefetch."""
        out = np.empty((len(ids), self.dim),
                       np.float32 if self.codec is not None
                       else self.slow.dtype)
        for j, i in enumerate(ids):
            i = int(i)
            if i in self.cache:
                self.stats.hits += 1
                self.cache.move_to_end(i)
            else:
                self.stats.misses += 1
                batch = [i]
                if neighbor_fn is not None:
                    for nb in neighbor_fn(i):
                        if len(batch) >= self.p:
                            break
                        nb = int(nb)
                        if nb >= 0 and nb not in self.cache and nb not in batch:
                            batch.append(nb)
                else:
                    batch.extend(x for x in range(i + 1, min(i + self.p,
                                                             len(self.slow))))
                self._transaction(batch)
            out[j] = self.cache[i]
        return out


def graph_neighbor_fn(g: HNSWGraph, layer: int):
    table = g.neighbors0 if layer == 0 else g.upper[layer - 1]

    def fn(i: int):
        row = table[i]
        return row[row >= 0]

    return fn


class TieredIndex(VectorIndex):
    """``VectorIndex`` whose searches run through the two-tier store: graph
    topology and keys in the fast tier, the row payload in the slow tier,
    every search paying (and counting) slow-tier transactions.

    Mutations go to the inner ``HNSW``'s impl layer (tombstones included;
    the inner index is never attached to a store, the outer one logs) and
    drop the tiers, so the next query re-warms them against the current
    graph. ``stats`` accumulates ``TierStats`` across the queries between
    mutations.
    """

    kind = "tiered"

    def __init__(self, *, metric: str = "cosine", M: int = 16,
                 ef_construction: int = 200, ef_search: int = 64,
                 cache_rows: int = 1024, prefetch_p: int | None = None,
                 seed: int = 0, use_bulk_build: bool = False,
                 n_shards: int = 1, dtype: str = "fp32",
                 rerank_factor: int | None = None,
                 beam_impl: str = "fused", device=None):
        from repro_torch.core.codec import get_codec
        from repro_torch.core.interface import HNSW   # lazy: import cycle
        self.n_shards = int(n_shards)
        self.dtype = str(dtype)
        self.rerank_factor = rerank_factor
        self.beam_impl = beam_impl
        self._codec = get_codec(self.dtype)
        self.inner = HNSW(distance_function=metric, M=M,
                          ef_construction=ef_construction,
                          ef_search=ef_search, seed=seed,
                          use_bulk_build=use_bulk_build,
                          n_shards=self.n_shards, dtype=self.dtype,
                          rerank_factor=rerank_factor,
                          beam_impl=beam_impl, device=device)
        self.metric = metric
        self.ef_search = ef_search
        self.cache_rows = cache_rows
        self.prefetch_p = prefetch_p
        # the fast-tier cache; not the durability IndexStore (``_store``)
        self._tier_store: TieredVectorStore | None = None
        self._g: HNSWGraph | None = None
        # sharded: one (graph, tier store, child) triple a shard
        self._tier_shards: list | None = None

    # ------------------------------------------------------------ mutation
    def _invalidate(self):
        self._tier_store = None
        self._g = None
        self._tier_shards = None
        self._bump_epoch()

    def _insert_impl(self, key: str, value: np.ndarray) -> None:
        self.inner._insert_impl(key, value)
        self._invalidate()

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
        self.inner._bulk_insert_impl(keys, values)
        self._invalidate()

    def _update_impl(self, key: str, value: np.ndarray) -> None:
        self.inner._update_impl(key, value)
        self._invalidate()

    def _delete_impl(self, key: str) -> None:
        self.inner._delete_impl(key)
        self._invalidate()

    def _compact_impl(self) -> None:
        """Physically drop tombstoned rows: the inner graph is rebuilt over
        the live rows and the tiers re-warm lazily."""
        self.inner._compact_impl()
        self._invalidate()

    # --------------------------------------------------------------- query
    def _tiers(self) -> tuple[HNSWGraph, TieredVectorStore]:
        if self.inner._builder is None:
            raise ValueError("index is empty")
        if self._g is None:
            self._g = self.inner._builder.graph()
            self._tier_store = TieredVectorStore(self._g.vectors,
                                                 cache_rows=self.cache_rows,
                                                 prefetch_p=self.prefetch_p,
                                                 codec=self._codec)
        return self._g, self._tier_store

    def _tiers_sharded(self) -> list:
        """Per-shard (graph, tier store, child) triples: every shard's
        payload is its own slow tier with its own fast-tier cache. Empty
        shards are skipped."""
        if self._tier_shards is None:
            out = []
            for child in self.inner._shards:
                if child._builder is None:
                    continue
                g = child._builder.graph()
                out.append((g, TieredVectorStore(
                    g.vectors, cache_rows=self.cache_rows,
                    prefetch_p=self.prefetch_p, codec=self._codec), child))
            if not out:
                raise ValueError("index is empty")
            self._tier_shards = out
        return self._tier_shards

    @property
    def stats(self) -> TierStats:
        if self.n_shards == 1:
            return self._tiers()[1].stats
        total = TierStats()
        for _, store, _ in self._tiers_sharded():
            for f in dataclasses.fields(TierStats):
                setattr(total, f.name, getattr(total, f.name)
                        + getattr(store.stats, f.name))
        return total

    def query_batch(self, queries, k: int = 10, ef: int | None = None):
        """Batched search through the two-tier store, a query at a time
        (the host beam is the accounting model); all B queries share one
        warmed fast-tier cache."""
        ef = max(ef or self.ef_search, k)
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        if self.n_shards > 1:
            # the inner index's device fan-out over the same segment set
            return self.inner._query_batch_sharded(q, k, ef)
        g, store = self._tiers()
        self.inner._ensure_tombstones()
        deleted = self.inner._deleted
        out_keys, out_d = [], []
        for qv in q:
            ids, dists = _tiered_beam_search(g, deleted, store, qv, k, ef)
            out_keys.append([self.inner._keys[i] if i >= 0 else None
                             for i in ids])
            out_d.append(dists)
        return out_keys, np.asarray(out_d, np.float32)

    def _query_batch_sharded_loop(self, q: np.ndarray, k: int, ef: int):
        """Each shard's host beam over its own graph and tier store, the
        candidates merged by distance (a stable sort in shard order)."""
        tiers = self._tiers_sharded()
        out_keys, out_d = [], []
        for qv in q:
            cand: list[tuple[float, str]] = []
            for g, store, child in tiers:
                child._ensure_tombstones()
                ids, dists = _tiered_beam_search(g, child._deleted, store,
                                                 qv, k, ef)
                cand.extend((d, child._keys[i])
                            for d, i in zip(dists, ids) if i >= 0)
            cand.sort(key=lambda c: c[0])
            cand = cand[:k]
            out_keys.append([key for _, key in cand]
                            + [None] * (k - len(cand)))
            out_d.append([d for d, _ in cand]
                         + [float(np.float32(3e38))] * (k - len(cand)))
        return out_keys, np.asarray(out_d, np.float32)

    def exact_query(self, query, k: int = 10):
        return self.inner.exact_query(query, k)

    # --------------------------------------------------------- persistence
    def config_dict(self) -> dict:
        return {"metric": self.metric, "M": self.inner.M,
                "ef_construction": self.inner.ef_construction,
                "ef_search": self.ef_search,
                "cache_rows": self.cache_rows,
                "prefetch_p": self.prefetch_p,
                "seed": self.inner.seed,
                "use_bulk_build": self.inner.use_bulk_build,
                "n_shards": self.n_shards, "dtype": self.dtype,
                "rerank_factor": self.rerank_factor,
                "beam_impl": self.beam_impl}

    def state_dict(self) -> tuple[dict, dict]:
        """The inner HNSW's state (graph, tombstones, RNG) plus the outer
        epoch, which serving caches key on; the tiers are re-derived on
        the first query."""
        arrays, meta = self.inner.state_dict()
        return arrays, dict(meta, outer_epoch=self._epoch)

    def restore_state(self, arrays: dict, meta: dict) -> None:
        self.inner.restore_state(arrays, meta)
        self._epoch = int(meta["outer_epoch"])
        self._tier_store = None
        self._g = None
        self._tier_shards = None

    def _row_count(self) -> int:
        return self.inner._row_count()

    @property
    def size(self) -> int:
        return self.inner.size

    def _contains(self, key: str) -> bool:
        return self.inner._contains(key)

    def keys(self) -> list[str]:
        return self.inner.keys()

    @property
    def shard_count(self) -> int:
        return self.n_shards

    def shard_stats(self) -> list[dict]:
        return self.inner.shard_stats()


def _tiered_beam_search(g: HNSWGraph, deleted: np.ndarray,
                        store: TieredVectorStore, q: np.ndarray, k: int,
                        ef: int) -> tuple[list[int], list[float]]:
    """Host HNSW search reading rows only through the tiered store (greedy
    upper-layer descent, then the ef-beam on layer 0). Tombstoned ids are
    traversed but not returned."""
    if g.metric == "cosine":
        q = q / max(float(np.linalg.norm(q)), 1e-12)
    ep = int(g.entry)
    d_ep = float(_dist(g.metric, q, store.read([ep],
                                               graph_neighbor_fn(g, 0)))[0])
    for layer in range(g.max_level, 0, -1):
        nb_fn = graph_neighbor_fn(g, layer)
        improved = True
        while improved:
            improved = False
            nbrs = [int(x) for x in nb_fn(ep)]
            if not nbrs:
                break
            d = _dist(g.metric, q, store.read(nbrs, nb_fn))
            j = int(np.argmin(d))
            if float(d[j]) < d_ep:
                ep, d_ep = nbrs[j], float(d[j])
                improved = True
    nb_fn = graph_neighbor_fn(g, 0)
    beam = [(d_ep, ep)]
    visited = {ep}
    expanded: set[int] = set()
    for _ in range(ef):
        cands = [(d, i) for d, i in beam if i not in expanded]
        if not cands:
            break
        _, cur = min(cands)
        expanded.add(cur)
        nbrs = [int(x) for x in g.neighbors0[cur] if x >= 0
                and int(x) not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        d = _dist(g.metric, q, store.read(nbrs, nb_fn))
        beam.extend(zip(d.tolist(), nbrs))
        beam = sorted(beam)[:ef]
    live = [(d, i) for d, i in beam if not deleted[i]][:k]
    ids = [i for _, i in live] + [-1] * (k - len(live))
    dists = [d for d, _ in live] + [float(np.float32(3e38))] * (k - len(live))
    return ids, dists


def simulate_search_traffic(g: HNSWGraph, queries: np.ndarray, *, ef: int,
                            cache_rows: int, prefetch_p: int | None,
                            use_graph_prefetch: bool = True) -> TierStats:
    """Replay HNSW layer-0 beam searches through the tiered store, counting
    slow-tier transactions — the experiment behind the paper's §3.2
    claim."""
    store = TieredVectorStore(g.vectors, cache_rows=cache_rows,
                              prefetch_p=prefetch_p)
    nb_fn = graph_neighbor_fn(g, 0) if use_graph_prefetch else None
    for q in queries:
        if g.metric == "cosine":
            q = q / max(float(np.linalg.norm(q)), 1e-12)
        ep = g.entry
        beam = [(float(_dist(g.metric, q, store.read([ep], nb_fn))[0]), ep)]
        visited = {ep}
        expanded: set[int] = set()
        for _ in range(ef):
            cands = [(d, i) for d, i in beam if i not in expanded]
            if not cands:
                break
            _, cur = min(cands)
            expanded.add(cur)
            nbrs = [int(x) for x in g.neighbors0[cur] if x >= 0
                    and int(x) not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            rows = store.read(nbrs, nb_fn)
            d = _dist(g.metric, q, rows)
            beam.extend(zip(d.tolist(), nbrs))
            beam = sorted(beam)[:ef]
    return store.stats
