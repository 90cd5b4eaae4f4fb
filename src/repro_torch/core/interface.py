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

This slice serves ``n_shards=1``; sharding is queued in ROADMAP.md §0 and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw as thnsw
from repro_torch.core import hnsw_build as build
from repro_torch.core.codec import (check_codec_arrays, effective_rerank,
                                    get_codec, rerank_exact)
from repro_torch.core.flat import FlatIndex
from repro_torch.core.hnsw_build import normalize_rows
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
                "n_shards > 1 is not ported yet (ROADMAP.md §0 queue: "
                "multi-GPU)")
        self.n_shards = 1
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
        if key in self._key2id:
            self._delete_impl(key)
        v = np.asarray(value, np.float32)
        if self._codec.lossy:
            self._insert_node(key, *self._quantize(v))
        else:
            self._insert_node(key, v)

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
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
        rows) serializes as the empty state."""
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
        if int(meta.get("n_shards", 1)) != 1:
            raise NotImplementedError(
                "restoring a state recorded at n_shards="
                f"{meta['n_shards']} needs resharding, which is not ported "
                "yet (ROADMAP.md §0 queue: multi-GPU)")
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

