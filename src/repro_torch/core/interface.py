"""MeMemo-parity public API (paper §2.1, Code 1) as a ``VectorIndex``
backend, ported from ``repro/core/interface.py``.

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

Row codecs (``dtype``): a lossy codec (bf16, int8) quantizes each row once
at ingest, after the metric normalization. The encoded rows (+ int8
scales) are canonical: the device graph holds them, and the builder's fp32
rows are their exact decode. ANN queries over-fetch ``k · rerank_factor``
candidates and rerank them exactly in fp32 against the builder's rows.

``use_bulk_build``: the first ``bulk_insert`` into an empty index builds
the graph with ``hnsw_build.bulk_build`` on the index's device (over the
decoded rows under a lossy codec) and adopts it as the builder's state, so
later inserts append.

``exact_query``, the recall oracle, scans the builder's live rows with
``FlatIndex`` (the ``distance_topk`` kernel on the card).

Persistence (``state_dict``/``restore_state``, the store, export/load):
the builder's capacity-padded arrays go to disk as they are, with the
builder's RNG state, so a restore adopts them without a rebuild and WAL
replay of later inserts draws the same levels; lossy codecs persist the
canonical encoded rows. After a restore the device graph is uploaded by
the first query. ``compact`` rebuilds the graph over the live rows and
carries their encoded rows through (secure delete).

Sharded operation (``n_shards > 1``): a navigable small-world graph
cannot be row-partitioned without changing its search, so the sharded
HNSW is a segment set: each shard owns an independent child ``HNSW``
(host builder, ``seed + j``, on its shard's device, ``shard_devices``)
over its hash-routed keys. CRUD routes to the owning shard and mirrors
the child's epoch delta onto the outer index. ANN queries run every
child's search on its own device and merge through the tree
(``core/stacked.py``); the exact phase searches epoch-cached placed
blocks (``build_exact_blocks``/``exact_topk_blocks``), so it does not
depend on the shard count. A global insertion-sequence table rides in
``state_dict``, so a snapshot restores at another shard count: the live
rows replay into fresh builders in canonical order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw as thnsw
from repro_torch.core import hnsw_build as build
from repro_torch.core import stacked as tstacked
from repro_torch.core.codec import (check_codec_arrays, effective_rerank,
                                    get_codec, rerank_exact)
from repro_torch.core.flat import FlatIndex
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.core.index import VectorIndex
from repro_torch.core.sharded import (build_exact_blocks, exact_topk_blocks,
                                      shard_devices, shard_of_key)
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
        self.n_shards = int(n_shards)
        self.use_bulk_build = use_bulk_build
        # row-storage codec: a lossy codec quantizes each row once at
        # ingest; ANN queries over-fetch k·rerank_factor, rerank in fp32
        self.dtype = str(dtype)
        self.rerank_factor = rerank_factor
        self._codec = get_codec(self.dtype)
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
        # canonical encoded rows [n, D] + per-row scales [n] (lossy only;
        # node-id aligned with the builder, appended per insert)
        self._enc: np.ndarray | None = None
        self._scales: np.ndarray | None = None
        self._device_graph: thnsw.DeviceGraph | None = None
        self._deleted_dirty = False
        # sharded segment set (n_shards > 1): child graphs, routing and the
        # canonical insertion-sequence table
        self._shards: list["HNSW"] = []
        self._key2shard: dict[str, int] = {}
        self._seq: dict[str, int] = {}
        self._next_seq = 0
        # epoch-keyed derived device state (sharded only): the segment
        # set, the gid-aligned fp32 rerank rows and the exact-phase
        # blocks. Restores drop them explicitly (_drop_derived): a
        # restore may land on the same epoch with other rows.
        self._stacked_cache: tuple | None = None
        self._rerank_rows_cache: tuple | None = None
        self._exact_cache: tuple | None = None
        self._devices = ([self.device] if self.n_shards == 1
                         else shard_devices(self.n_shards, self.device))
        if self.n_shards > 1:
            self._shards = self._new_children()

    # --------------------------------------------------- shard plumbing
    def _new_children(self) -> list["HNSW"]:
        """Empty 1-shard children, child j seeded ``seed + j`` on shard
        j's device (always the host builder, as the reference)."""
        return [HNSW(distance_function=self.metric, M=self.M,
                     ef_construction=self.ef_construction,
                     ef_search=self.ef_search, seed=self.seed + j,
                     use_bulk_build=False, n_shards=1, dtype=self.dtype,
                     rerank_factor=self.rerank_factor,
                     beam_impl=self.beam_impl, device=self._devices[j])
                for j in range(self.n_shards)]

    @property
    def shard_count(self) -> int:
        return self.n_shards

    def _mirror(self, child: "HNSW", fn, *args) -> None:
        """Run a child's impl and mirror its epoch delta onto the outer
        index, so the outer ``mutation_epoch`` advances exactly as the
        1-shard index's would for the same op."""
        before = child._epoch
        fn(*args)
        self._epoch += child._epoch - before

    def _route(self, key: str, s: int) -> None:
        """Record an insert routed to shard ``s`` and its sequence."""
        self._key2shard[key] = s
        self._seq[key] = self._next_seq
        self._next_seq += 1

    # ------------------------------------------------------------ mutation
    def _quantize(self, v: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, float | None]:
        """Put one raw row in its final stored form: metric normalization,
        then ONE codec encode whose decode becomes the stored fp32 row."""
        if self.metric == "cosine":
            v = v / max(float(np.linalg.norm(v)), 1e-12)
        enc, scales = self._codec.encode(v[None])
        v = self._codec.decode(enc, scales)[0]
        return v, enc[0], (None if scales is None else scales[0])

    def _append_enc(self, enc_row: np.ndarray,
                    scale: float | None) -> None:
        if self._enc is None:
            self._enc = np.zeros((0, enc_row.shape[-1]),
                                 self._codec.enc_dtype)
        self._enc = np.concatenate([self._enc, enc_row[None]])
        if scale is not None:
            if self._scales is None:
                self._scales = np.zeros(0, np.float32)
            self._scales = np.concatenate(
                [self._scales, np.asarray([scale], np.float32)])

    def _insert_node(self, key: str, v: np.ndarray,
                     enc_row: np.ndarray | None = None,
                     scale: float | None = None) -> None:
        """Commit one row to the builder and, with its encoding, the
        encoded side arrays. A row with an encoding is already final
        (``_quantize``); a raw fp32 row is normalized by the builder."""
        if self._builder is None:
            self._builder = build.SequentialBuilder(
                v.shape[-1], M=self.M, ef_construction=self.ef_construction,
                metric=self.metric, seed=self.seed)
        node = self._builder.insert(v, prenormalized=enc_row is not None)
        if node != len(self._keys):
            raise RuntimeError("builder node ids out of step with the keys")
        self._keys.append(key)
        self._key2id[key] = node
        if enc_row is not None:
            self._append_enc(enc_row, scale)
        self._bump_epoch()

    def _insert_impl(self, key: str, value: np.ndarray) -> None:
        """Upsert one (key, vector); existing keys are updated in place."""
        if self.n_shards > 1:
            s = shard_of_key(key, self.n_shards)
            self._mirror(self._shards[s], self._shards[s]._insert_impl,
                         key, np.asarray(value, np.float32))
            self._route(key, s)
            return
        if key in self._key2id:
            self._delete_impl(key)
        v = np.asarray(value, np.float32)
        if self._codec.lossy:
            self._insert_node(key, *self._quantize(v))
        else:
            self._insert_node(key, v)

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
        if self.n_shards > 1:
            # routed inserts in global order: per-shard insertion
            # sequences do not depend on batch boundaries
            before = self._epoch
            first_bulk = self.use_bulk_build and self._row_count() == 0
            for k, v in zip(keys, values):
                self._insert_impl(k, v)
            if first_bulk:
                # the 1-shard bulk build bumps ONCE for the whole first
                # batch; the WAL's epoch chain needs the same delta at
                # every shard count
                self._epoch = before + 1
            return
        if self.use_bulk_build and self._builder is None:
            values = np.asarray(values, np.float32)
            if self._codec.lossy:
                # normalize + quantize the whole batch once; the graph is
                # built over the decoded (final, stored) rows
                if self.metric == "cosine":
                    values = normalize_rows(values)
                enc, scales = self._codec.encode(values)
                values = self._codec.decode(enc, scales)
                self._enc = enc
                self._scales = scales
            self._adopt_bulk_graph(keys, values,
                                   prenormalized=self._codec.lossy)
            return
        for k, v in zip(keys, values):
            self._insert_impl(k, v)

    def _adopt_bulk_graph(self, keys: list[str], values: np.ndarray,
                          prenormalized: bool) -> None:
        """Build a whole graph with the device-resident bulk ingest and
        adopt it as mutable builder state, so a LATER bulk_insert / insert
        appends instead of replacing the graph."""
        g = build.bulk_build(
            values, M=self.M, ef_construction=self.ef_construction,
            metric=self.metric, seed=self.seed,
            prenormalized=prenormalized, beam_impl=self.beam_impl,
            device=self.device)
        self._builder = build.SequentialBuilder.from_graph(
            g, ef_construction=self.ef_construction, seed=self.seed)
        self._keys = list(keys)
        self._key2id = {k: i for i, k in enumerate(self._keys)}
        self._device_graph = None
        self._bump_epoch()

    bulkInsert = VectorIndex.bulk_insert   # TS-parity alias

    def _update_impl(self, key: str, value: np.ndarray) -> None:
        """Replace the vector of an existing key (delete + reinsert)."""
        self._insert_impl(key, value)

    def _delete_impl(self, key: str) -> None:
        """Soft-delete: tombstone the row; it stays traversable but is
        never returned again."""
        if self.n_shards > 1:
            s = self._key2shard.pop(key)           # KeyError if absent
            self._seq.pop(key, None)
            self._mirror(self._shards[s], self._shards[s]._delete_impl, key)
            return
        node = self._key2id.pop(key)               # KeyError if absent
        self._ensure_tombstones()
        self._deleted[node] = True
        self._deleted_dirty = True
        self._bump_epoch()

    def _compact_impl(self) -> None:
        """Physically drop tombstoned rows: rebuild the graph from scratch
        over the live rows only (fresh builder, fresh RNG). The canonical
        encoded rows of the live rows ride through the rebuild, so a
        deleted row's encoded bytes and scale die with its fp32 bytes and
        no live row is re-quantized."""
        if self.n_shards > 1:
            # the outer delta matches the 1-shard path for the same live
            # set: one bump per reinserted row, or one when nothing lives
            live_total = self.size
            for child in self._shards:
                child._compact_impl()
            self._epoch += live_total if live_total else 1
            return
        if self._builder is None:
            self._bump_epoch()
            return
        self._ensure_tombstones()
        n = self._builder.n
        live = np.flatnonzero(~self._deleted[:n])
        vecs = self._builder.vectors[live].copy()
        keys = [self._keys[i] for i in live]
        enc = self._enc[live].copy() if self._enc is not None else None
        scl = self._scales[live].copy() if self._scales is not None else None
        self._clear()
        if self._codec.lossy:
            for i, (k, v) in enumerate(zip(keys, vecs)):
                self._insert_node(k, v, enc[i],    # bumps epoch per insert
                                  None if scl is None else scl[i])
        else:
            for k, v in zip(keys, vecs):
                self._insert_impl(k, v)            # bumps epoch per insert
        if not keys:
            self._bump_epoch()

    def _clear(self) -> None:
        """Drop every row: no builder, keys, tombstones or device graph
        (the epoch stays)."""
        self._builder = None
        self._keys = []
        self._key2id = {}
        self._deleted = np.zeros(0, bool)
        self._enc = None
        self._scales = None
        self._device_graph = None
        self._deleted_dirty = False

    def _ensure_tombstones(self):
        cap = self._builder.vectors.shape[0] if self._builder is not None else 0
        if self._deleted.shape[0] < cap:
            pad = np.zeros(cap - self._deleted.shape[0], bool)
            self._deleted = np.concatenate([self._deleted, pad])

    # ----------------------------------------------------- device residency
    def _enc_capacity(self, cap: int
                      ) -> tuple[np.ndarray | None, np.ndarray | None]:
        """Canonical encoded rows padded to the builder's capacity view
        (zeros beyond ``n``, as the builder's rows), the shape the device
        graph uses."""
        if self._enc is None:
            return None, None
        n, d = self._enc.shape
        enc = np.zeros((cap, d), self._codec.enc_dtype)
        enc[:n] = self._enc
        scl = None
        if self._scales is not None:
            scl = np.zeros(cap, np.float32)
            scl[:n] = self._scales
        return enc, scl

    def _dg(self) -> thnsw.DeviceGraph:
        """Resident device graph, synced incrementally when possible.
        Under a lossy codec the resident rows are the ENCODED rows (+ the
        int8 scale table); every distance decodes inside the kernels."""
        if self._builder is None:
            raise ValueError("index is empty")
        b = self._builder
        self._ensure_tombstones()
        g = b.graph_full_capacity(b.max_level_cap)   # fixed [12, cap, M] upper
        dg = self._device_graph
        if dg is None or tuple(dg.vectors.shape) != g.vectors.shape:
            # first upload, or capacity growth: full conversion
            enc, scl = self._enc_capacity(g.vectors.shape[0])
            self._device_graph = thnsw.to_device_graph(
                g, self._deleted, enc=enc, scales=scl, device=self.device)
            b.journal.clear()
            self._deleted_dirty = False
        elif b.journal or self._deleted_dirty or dg.max_level != g.max_level:
            # incremental: only dirty rows travel to the device; the
            # canonical [n, D] encoded arrays are indexed by dirty row id
            self._device_graph = thnsw.apply_row_updates(
                dg, g, b.journal,
                self._deleted if self._deleted_dirty else None,
                enc=self._enc, scales=self._scales)
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
        """One lock-step device search for the whole [B, D] batch. Under a
        lossy codec it over-fetches ``k · rerank_factor`` candidates and
        reranks them exactly in fp32 against the builder's rows."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        if self.n_shards > 1:
            return self._query_batch_sharded(q, k, ef)
        rf = effective_rerank(self._codec, self.rerank_factor)
        ids, dists = thnsw.search_graph(self._dg(), q, k=k * rf,
                                        ef=ef or self.ef_search,
                                        beam_impl=self.beam_impl)
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        if rf > 1:
            # the beam already dropped tombstoned ids: every candidate is
            # live
            n = self._builder.n
            dists, ids = rerank_exact(self._builder.vectors[:n], q, ids, k,
                                      metric=self.metric)
        keys = [[self._keys[i] if i >= 0 else None for i in row] for row in ids]
        return keys, dists

    def _drop_derived(self) -> None:
        """Drop the epoch-keyed derived device state (a restore can land
        on the cached epoch with other rows)."""
        self._stacked_cache = None
        self._rerank_rows_cache = None
        self._exact_cache = None

    def _stacked(self) -> tstacked.StackedGraphs:
        """Epoch-cached segment set: each child's resident device graph,
        synced incrementally by its ``_dg()``."""
        if (self._stacked_cache is not None
                and self._stacked_cache[0] == self._epoch):
            return self._stacked_cache[1]
        st = tstacked.stack_device_graphs(
            [child._dg() if child._builder is not None else None
             for child in self._shards])
        self._stacked_cache = (self._epoch, st)
        return st

    def _rerank_rows(self, st: tstacked.StackedGraphs) -> np.ndarray:
        """Epoch-cached gid-aligned canonical fp32 rows [S·cap, D]: the
        fan-out's global ids index it directly for the lossy rerank."""
        if (self._rerank_rows_cache is not None
                and self._rerank_rows_cache[0] == self._epoch):
            return self._rerank_rows_cache[1]
        dim = next(g for g in st.graphs if g is not None).vectors.shape[1]
        rows = np.zeros((self.n_shards * st.cap, dim), np.float32)
        for s, child in enumerate(self._shards):
            if child._builder is not None:
                n = child._builder.n
                rows[s * st.cap:s * st.cap + n] = child._builder.vectors[:n]
        self._rerank_rows_cache = (self._epoch, rows)
        return rows

    def _query_batch_sharded(self, q: np.ndarray, k: int, ef: int | None):
        """Every child's search on its own device, the tree merge on the
        first shard's; lossy codecs over-fetch ``k · rerank_factor`` a
        shard, merge, and rerank the merged candidates exactly in fp32
        against the gid-aligned canonical rows."""
        st = self._stacked()
        rf = effective_rerank(self._codec, self.rerank_factor)
        kf = k * rf
        d, gid = tstacked.search_stacked(st, q, kf,
                                         max(ef or self.ef_search, kf),
                                         beam_impl=self.beam_impl)
        if rf > 1:
            d, gid = rerank_exact(self._rerank_rows(st), q, gid, k,
                                  metric=self.metric)
        cap = st.cap
        keys = [[self._shards[int(g) // cap]._keys[int(g) % cap]
                 if g >= 0 else None for g in row] for row in gid]
        return keys, d

    def _query_batch_sharded_loop(self, q: np.ndarray, k: int,
                                  ef: int | None):
        """Per-child fan-out with a host merge (S searches, a stable sort
        of their concatenation): the parity oracle of the fan-out."""
        parts = [child.query_batch(q, k=k, ef=ef)
                 for child in self._shards if child._builder is not None]
        if not parts:
            raise ValueError("index is empty")
        d_cat = np.concatenate([d for _, d in parts], axis=1)     # [B, C*k]
        k_cat = [sum((pk[b] for pk, _ in parts), [])
                 for b in range(q.shape[0])]
        order = np.argsort(d_cat, axis=1, kind="stable")[:, :k]
        dists = np.take_along_axis(d_cat, order, axis=1)
        keys = [[k_cat[b][j] for j in order[b]] for b in range(q.shape[0])]
        return keys, dists

    def exact_query(self, query, k: int = 10):
        """Brute-force oracle over the same LIVE rows -> (keys, dists),
        ``min(k, live)`` columns: a ``FlatIndex`` over the builder's rows
        (already normalized for cosine) on the index's device. Sharded:
        the epoch-cached placed blocks, every shard scanning its own live
        rows, merged by the tree — so exact results do not depend on the
        shard count and steady-state calls upload nothing."""
        if self.n_shards > 1:
            return self._exact_query_sharded(query, k)
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

    def _live_by_seq(self) -> list[tuple[int, str, int, int]]:
        """Live rows in canonical (insertion-sequence) order:
        [(seq, key, shard, node)]."""
        items = []
        for s, child in enumerate(self._shards):
            for key, node in child._key2id.items():
                items.append((self._seq[key], key, s, node))
        items.sort()
        return items

    def _exact_placed(self):
        """Epoch-cached exact-phase blocks: (items, placed). The host
        repack and upload happen once a mutation epoch."""
        if (self._exact_cache is not None
                and self._exact_cache[0] == self._epoch):
            return self._exact_cache[1], self._exact_cache[2]
        items = self._live_by_seq()
        # canonical gid = rank in insertion order, grouped a shard
        ranks: list[list[int]] = [[] for _ in range(self.n_shards)]
        nodes: list[list[int]] = [[] for _ in range(self.n_shards)]
        for rank, (_, _, s, node) in enumerate(items):
            ranks[s].append(rank)
            nodes[s].append(node)
        dim = 0
        groups = []
        for s, child in enumerate(self._shards):
            if child._builder is not None:
                dim = int(child._builder.vectors.shape[1])
            if ranks[s] and child._builder is not None:
                vecs = np.asarray(child._builder.vectors[nodes[s]],
                                  np.float32)
            else:
                vecs = np.zeros((0, 0), np.float32)
            groups.append((vecs, np.asarray(ranks[s], np.int32)))
        # lossy rows are already in final stored form (normalized before
        # quantization): re-normalizing them would score other values
        placed = build_exact_blocks(
            groups, dim, self._devices,
            normalize=(self.metric == "cosine" and not self._codec.lossy))
        self._exact_cache = (self._epoch, items, placed)
        return items, placed

    def _exact_query_sharded(self, query, k: int):
        items, placed = self._exact_placed()
        if not items:
            raise ValueError("index is empty")
        q = np.asarray(query, np.float32)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None]
        d, g = exact_topk_blocks(placed, q, min(k, len(items)),
                                 metric=self.metric)
        keys = [[items[int(j)][1] if j >= 0 else None for j in row]
                for row in g]
        if squeeze:
            return keys[0], d[0]
        return keys, d

    # ------------------------------------------------------- persistence
    def config_dict(self) -> dict:
        return {"metric": self.metric, "M": self.M,
                "ef_construction": self.ef_construction,
                "ef_search": self.ef_search, "seed": self.seed,
                "use_bulk_build": self.use_bulk_build,
                "n_shards": self.n_shards, "dtype": self.dtype,
                "rerank_factor": self.rerank_factor,
                "beam_impl": self.beam_impl}

    def state_dict(self) -> tuple[dict, dict]:
        """Full mutation-determined host state, CAPACITY-padded: the
        builder's fixed-shape arrays go to disk as they are, so restore
        adopts them directly and the first query does one plain device
        upload — no graph rebuild. The builder RNG state rides along so
        WAL replay of later inserts draws the same levels. An index with
        no builder (nothing inserted, or compacted down to zero live
        rows) serializes as the empty state.

        Sharded: one namespaced sub-state a shard plus the canonical
        insertion-sequence table, which lets a snapshot restore at
        another shard count."""
        if self.n_shards > 1:
            arrays: dict = {}
            shard_meta = []
            for j, child in enumerate(self._shards):
                a, m = child.state_dict()
                for name, v in a.items():
                    arrays[f"s{j}__{name}"] = v
                shard_meta.append(m)
            meta = {"n_shards": self.n_shards, "epoch": self._epoch,
                    "shards": shard_meta,
                    "seq": sorted(self._seq.items(), key=lambda kv: kv[1]),
                    "next_seq": self._next_seq}
            return arrays, meta
        if self._builder is None:
            arrays = {"levels": np.zeros(0, np.int32),
                      "neighbors0": np.zeros((0, 2 * self.M), np.int32),
                      "upper": np.zeros((0, 0, self.M), np.int32),
                      "deleted": np.zeros(0, bool)}
            if self._codec.lossy:
                arrays["vectors_enc"] = self._codec.to_storage(
                    np.zeros((0, 0), self._codec.enc_dtype))
                if self._codec.uses_scales:
                    arrays["scales"] = np.zeros(0, np.float32)
            else:
                arrays["vectors"] = np.zeros((0, 0), np.float32)
            meta = {"keys": [], "epoch": self._epoch, "n": 0, "entry": -1,
                    "max_level": -1, "max_level_cap": 12, "rng_state": None}
            return arrays, meta
        b = self._builder
        self._ensure_tombstones()
        arrays = {"levels": b.levels, "neighbors0": b.neighbors0,
                  "upper": b.upper, "deleted": self._deleted}
        if self._codec.lossy:
            # the CANONICAL encoded rows + scales, capacity-padded like
            # the builder arrays; restore decodes them to the exact
            # builder rows
            enc, scl = self._enc_capacity(b.vectors.shape[0])
            arrays["vectors_enc"] = self._codec.to_storage(enc)
            if scl is not None:
                arrays["scales"] = scl
        else:
            arrays["vectors"] = b.vectors
        meta = {"keys": list(self._keys), "epoch": self._epoch,
                "n": int(b.n), "entry": int(b.entry),
                "max_level": int(b.max_level),
                "max_level_cap": int(b.max_level_cap),
                "rng_state": b.rng.bit_generator.state}
        return arrays, meta

    def restore_state(self, arrays: dict, meta: dict) -> None:
        check_codec_arrays(self._codec, arrays, self.kind)
        rec_shards = int(meta.get("n_shards", 1))
        if rec_shards != self.n_shards:
            # the shard count changed between snapshot and restore: replay
            # the canonical row sequence into the new layout
            self._restore_resharded(arrays, meta, rec_shards)
            return
        if self.n_shards > 1:
            for j, (child, m) in enumerate(zip(self._shards, meta["shards"])):
                sub = {name[len(f"s{j}__"):]: v for name, v in arrays.items()
                       if name.startswith(f"s{j}__")}
                child.restore_state(sub, m)
            self._key2shard = {k: s for s, c in enumerate(self._shards)
                               for k in c._key2id}
            self._seq = {k: int(v) for k, v in meta["seq"]}
            self._next_seq = int(meta["next_seq"])
            self._epoch = int(meta["epoch"])
            self._drop_derived()
            return
        self._clear()
        self._epoch = int(meta["epoch"])
        n = int(meta["n"])
        if n == 0:                        # empty state: no builder yet
            return
        if self._codec.lossy:
            # adopt the stored ENCODED rows as canonical and decode the
            # builder's fp32 side from them — never re-encode
            enc_cap = self._codec.from_storage(arrays["vectors_enc"])
            scl_cap = (np.asarray(arrays["scales"], np.float32)
                       if "scales" in arrays else None)
            vectors = self._codec.decode(enc_cap, scl_cap)
            self._enc = np.ascontiguousarray(enc_cap[:n])
            self._scales = (None if scl_cap is None
                            else np.ascontiguousarray(scl_cap[:n]))
        else:
            vectors = np.asarray(arrays["vectors"], np.float32)
        b = build.SequentialBuilder(
            vectors.shape[1], M=self.M,
            ef_construction=self.ef_construction, metric=self.metric,
            capacity=vectors.shape[0], max_level_cap=meta["max_level_cap"],
            seed=self.seed)
        b.vectors = vectors
        b.levels = np.asarray(arrays["levels"], np.int32)
        b.neighbors0 = np.asarray(arrays["neighbors0"], np.int32)
        b.upper = np.asarray(arrays["upper"], np.int32)
        b.n = n
        b.entry = int(meta["entry"])
        b.max_level = int(meta["max_level"])
        b.rng.bit_generator.state = meta["rng_state"]
        self._builder = b
        self._keys = list(meta["keys"])
        self._deleted = np.asarray(arrays["deleted"], bool).copy()
        self._key2id = {k: i for i, k in enumerate(self._keys)
                        if not self._deleted[i]}

    def _recorded_rows(self, arrays: dict, prefix: str = ""):
        """Recorded rows -> (fp32 vectors, encoded rows | None, scales |
        None), whatever codec wrote them."""
        if f"{prefix}vectors" in arrays:
            return (np.asarray(arrays[f"{prefix}vectors"], np.float32),
                    None, None)
        enc = self._codec.from_storage(arrays[f"{prefix}vectors_enc"])
        scl = arrays.get(f"{prefix}scales")
        return self._codec.decode(enc, scl), enc, scl

    def _canonical_rows(self, arrays: dict, meta: dict, rec_shards: int
                        ) -> list[tuple]:
        """Live rows of a recorded state in canonical insertion order:
        [(seq, key, vector, enc_row | None, scale | None)], encodings
        included so that a reshard keeps the canonical bytes."""
        def _row(vecs, enc, scl, node):
            return (vecs[node],
                    None if enc is None else enc[node],
                    None if scl is None else scl[node])

        rows: list[tuple] = []
        if rec_shards == 1:
            n = int(meta["n"])
            deleted = np.asarray(arrays["deleted"], bool)
            vecs, enc, scl = self._recorded_rows(arrays)
            for node in range(n):
                if not deleted[node]:
                    rows.append((node, meta["keys"][node],
                                 *_row(vecs, enc, scl, node)))
            return rows
        seqmap = {k: int(v) for k, v in meta["seq"]}
        for j, m in enumerate(meta["shards"]):
            n = int(m["n"])
            if n == 0:
                continue
            deleted = np.asarray(arrays[f"s{j}__deleted"], bool)
            vecs, enc, scl = self._recorded_rows(arrays, prefix=f"s{j}__")
            for node in range(n):
                key = m["keys"][node]
                if not deleted[node]:
                    rows.append((seqmap[key], key,
                                 *_row(vecs, enc, scl, node)))
        rows.sort(key=lambda r: r[0])
        return rows

    def _insert_canonical(self, key: str, vec: np.ndarray,
                          enc_row: np.ndarray | None,
                          scale: float | None) -> None:
        """Reshard-replay insert of an already-final row: routes like
        ``_insert_impl`` but adopts the recorded encoding instead of
        re-quantizing; fp32 rows replay through ``_insert_impl``."""
        if self.n_shards > 1:
            s = shard_of_key(key, self.n_shards)
            self._mirror(self._shards[s], self._shards[s]._insert_canonical,
                         key, vec, enc_row, scale)
            self._route(key, s)
            return
        if enc_row is None:
            self._insert_impl(key, vec)
            return
        self._insert_node(key, vec, enc_row, scale)

    def _restore_resharded(self, arrays: dict, meta: dict,
                           rec_shards: int) -> None:
        """Adopt a snapshot recorded at another shard count: a
        deterministic rebuild — live rows replay into fresh builders in
        canonical order (tombstoned rows do not survive). The epoch and
        the sequence table are kept, so epoch-keyed consumers and the
        order of ``keys()`` are unaffected."""
        rows = self._canonical_rows(arrays, meta, rec_shards)
        self._clear()
        self._drop_derived()
        self._key2shard = {}
        self._seq = {}
        self._next_seq = 0
        if self.n_shards > 1:
            self._shards = self._new_children()
        if (self.use_bulk_build and rows
                and all(r[3] is None for r in rows)):
            # a reshard of fp32 rows is a from-scratch rebuild: each
            # target builder adopts one bulk-built graph (lossy rows keep
            # the replay path, which adopts their recorded encodings)
            if self.n_shards == 1:
                self._adopt_bulk_graph([r[1] for r in rows],
                                       np.stack([r[2] for r in rows]),
                                       prenormalized=True)
            else:
                per: list[list[tuple]] = [[] for _ in range(self.n_shards)]
                for r in rows:
                    s = shard_of_key(r[1], self.n_shards)
                    per[s].append(r)
                    self._route(r[1], s)
                for s, child_rows in enumerate(per):
                    if child_rows:
                        self._shards[s]._adopt_bulk_graph(
                            [r[1] for r in child_rows],
                            np.stack([r[2] for r in child_rows]),
                            prenormalized=True)
        else:
            for _, key, vec, enc_row, scale in rows:
                self._insert_canonical(key, vec, enc_row, scale)
        if self.n_shards > 1:
            if rec_shards == 1:
                self._seq = {key: seq for seq, key, *_ in rows}
                self._next_seq = int(meta["n"])
            else:
                self._seq = {k: int(v) for k, v in meta["seq"]}
                self._next_seq = int(meta["next_seq"])
        self._epoch = int(meta["epoch"])

    # the paper's Code 1 names for export/load
    export_index = VectorIndex.export
    exportIndex = VectorIndex.export
    load_index = VectorIndex.load
    loadIndex = VectorIndex.load

    @property
    def size(self) -> int:
        if self.n_shards > 1:
            return len(self._key2shard)
        return len(self._key2id)

    def _contains(self, key: str) -> bool:
        if self.n_shards > 1:
            return key in self._key2shard
        return key in self._key2id

    def _row_count(self) -> int:
        if self.n_shards > 1:
            return sum(c._row_count() for c in self._shards)
        return self._builder.n if self._builder is not None else 0

    def keys(self) -> list[str]:
        if self.n_shards > 1:
            return [k for _, k in sorted(
                (self._seq[k], k) for k in self._key2shard)]
        n = self._row_count()
        self._ensure_tombstones()
        return [self._keys[i] for i in range(n) if not self._deleted[i]]

    def shard_stats(self) -> list[dict]:
        """Per-shard occupancy, the same convention at every shard count:
        slots = rows ever held (tombstones included), free = tombstoned,
        live = slots - free."""
        if self.n_shards == 1:
            return [{"shard": 0, "slots": self._row_count(),
                     "free": self._row_count() - self.size,
                     "live": self.size}]
        return [{"shard": s, "slots": c._row_count(),
                 "free": c._row_count() - c.size, "live": c.size}
                for s, c in enumerate(self._shards)]

