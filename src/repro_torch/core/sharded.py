"""Keyed mutable row substrate of the flat index, ported from
``repro/core/sharded.py`` for one device (``n_shards == 1``).

Two layers of state:

  * **canonical** (host, numpy): append-only fp32 rows ``[T, D]`` in
    insertion order, the row -> key table and the ``alive`` tombstone
    mask; under a lossy codec also the encoded rows and per-row scales,
    encoded ONCE at ingest (after cosine normalization) — the fp32 rows
    are then their exact decode.
  * **device** (lazy): a ``FlatIndex`` over the live rows, rebuilt on the
    first search after a mutation. Lossy rows upload encoded, as they are.

Placement bookkeeping (``shard_of_key`` routing, per-shard slot tables
with free-slot reuse) is kept as the reference has it, so ``shard_stats``
agrees. The canonical arrays are what a snapshot persists; ``compact``
and ``restore``/``restore_encoded`` adopt new canonical arrays and
re-derive placement. Several shards (a mesh of cards) are not ported yet
and raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.codec import (VectorCodec, device_rows, get_codec,
                                    rerank_exact)
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.utils import resolve_device


def shard_of_key(key: str, n_shards: int) -> int:
    """Deterministic key -> owning shard (stable blake2b, never Python
    ``hash``)."""
    if n_shards <= 1:
        return 0
    h = hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_shards


class ShardedRows:
    """Keyed mutable row storage on one device. All mutators are host-side
    and cheap; the device ``FlatIndex`` is packed lazily on the first
    search after a mutation."""

    def __init__(self, *, n_shards: int = 1, metric: str = "cosine",
                 dim: int | None = None, normalize_on_pack: bool = True,
                 codec: VectorCodec | str | None = None, device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards > 1:
            raise NotImplementedError(
                "n_shards > 1 is not ported yet (ROADMAP.md §1: multi-GPU)")
        self.n_shards = n_shards
        self.metric = metric
        self.dim = dim
        # cosine normalization by the substrate (flat semantics): at pack
        # time for fp32 rows, at ingest before the one encode for lossy
        # ones. IVF normalizes at insert instead and passes False, so its
        # rows are taken as they come.
        self.normalize_on_pack = normalize_on_pack
        self.device = resolve_device(device)
        self.codec = (codec if isinstance(codec, VectorCodec)
                      else get_codec(codec or "fp32"))
        self._vecs = np.zeros((0, dim or 0), np.float32)
        self._enc = (np.zeros((0, dim or 0), self.codec.enc_dtype)
                     if self.codec.lossy else None)
        self._scales = (np.zeros(0, np.float32)
                        if self.codec.uses_scales else None)
        self._keys: list[str] = []
        self._key2row: dict[str, int] = {}
        self._alive = np.zeros(0, bool)
        # placement
        self._row_shard = np.zeros(0, np.int32)
        self._row_slot = np.zeros(0, np.int32)
        self._slots: list[list[int]] = [[] for _ in range(n_shards)]
        self._free: list[list[int]] = [[] for _ in range(n_shards)]
        # device (lazy)
        self._flat = None
        self._live_rows: np.ndarray | None = None

    # ------------------------------------------------------------ canonical
    @property
    def vectors(self) -> np.ndarray:
        return self._vecs

    @property
    def encoded(self) -> np.ndarray | None:
        """Canonical codec-encoded rows [T, D] (None for fp32)."""
        return self._enc

    @property
    def scales(self) -> np.ndarray | None:
        """Canonical per-row decode scales [T] (int8 codec only)."""
        return self._scales

    @property
    def alive(self) -> np.ndarray:
        return self._alive

    @property
    def key_list(self) -> list[str]:
        return self._keys

    @property
    def key2row(self) -> dict[str, int]:
        return self._key2row

    @property
    def size(self) -> int:
        return len(self._key2row)

    @property
    def row_count(self) -> int:
        return len(self._keys)

    def live_keys(self) -> list[str]:
        return [k for i, k in enumerate(self._keys) if self._alive[i]]

    def key_of_row(self, row: int) -> str:
        return self._keys[row]

    def shard_stats(self) -> list[dict]:
        """Per-shard occupancy: live rows, free slots, block capacity."""
        out = []
        for s in range(self.n_shards):
            free = len(self._free[s])
            out.append({"shard": s, "slots": len(self._slots[s]),
                        "free": free, "live": len(self._slots[s]) - free})
        return out

    # ------------------------------------------------------------ mutation
    def _invalidate(self) -> None:
        self._flat = None
        self._live_rows = None

    def _ensure_dim(self, d: int) -> None:
        if self.dim is None:
            self.dim = d
            self._vecs = np.zeros((0, d), np.float32)
            if self._enc is not None:
                self._enc = np.zeros((0, d), self.codec.enc_dtype)

    def _ingest(self, vecs: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """Raw fp32 rows -> (canonical fp32, encoded, scales). Lossy
        codecs quantize here, once, after cosine normalization (when the
        substrate normalizes); fp32 rows pass through untouched."""
        vecs = np.asarray(vecs, np.float32)
        if not self.codec.lossy:
            return vecs, None, None
        if self.normalize_on_pack and self.metric == "cosine":
            vecs = normalize_rows(vecs)
        enc, scales = self.codec.encode(vecs)
        return self.codec.decode(enc, scales), enc, scales

    def _claim_slot(self, shard: int, row: int) -> int:
        free = self._free[shard]
        if free:
            slot = free.pop()
            self._slots[shard][slot] = row
        else:
            slot = len(self._slots[shard])
            self._slots[shard].append(row)
        return slot

    def _release_row(self, row: int) -> None:
        self._alive[row] = False
        s, slot = int(self._row_shard[row]), int(self._row_slot[row])
        self._slots[s][slot] = -1
        self._free[s].append(slot)

    def _append_enc(self, enc: np.ndarray | None,
                    scales: np.ndarray | None) -> None:
        if self._enc is not None:
            self._enc = np.concatenate([self._enc, enc])
        if self._scales is not None:
            self._scales = np.concatenate(
                [self._scales, np.asarray(scales, np.float32)])

    def upsert(self, key: str, vec: np.ndarray) -> None:
        vec = np.asarray(vec, np.float32).reshape(-1)
        self.upsert_many([key], vec[None])

    def upsert_many(self, keys: list[str], vecs: np.ndarray) -> None:
        vecs = np.asarray(vecs, np.float32)
        self._ensure_dim(vecs.shape[1])
        vecs, enc, scales = self._ingest(vecs)
        # pop as we release: a pre-existing key repeated WITHIN the batch
        # must free its old slot exactly once
        for key in keys:
            old = self._key2row.pop(key, None)
            if old is not None:
                self._release_row(old)
        base = len(self._keys)
        n = len(keys)
        self._vecs = np.concatenate([self._vecs, vecs])
        self._append_enc(enc, scales)
        self._keys.extend(keys)
        self._alive = np.concatenate([self._alive, np.ones(n, bool)])
        shards = np.zeros(n, np.int32)
        slots = np.zeros(n, np.int32)
        for j, key in enumerate(keys):
            self._key2row[key] = base + j
            shards[j] = shard_of_key(key, self.n_shards)
            slots[j] = self._claim_slot(int(shards[j]), base + j)
        self._row_shard = np.concatenate([self._row_shard, shards])
        self._row_slot = np.concatenate([self._row_slot, slots])
        self._invalidate()

    def tombstone(self, key: str) -> None:
        self._release_row(self._key2row.pop(key))
        self._invalidate()

    def contains(self, key: str) -> bool:
        return key in self._key2row

    def compact(self) -> None:
        """Physically drop tombstoned rows: the canonical arrays re-pack
        over live rows and the slot tables are rebuilt dense. After this
        a deleted row's bytes — the fp32 decode AND the encoded bytes +
        scale — exist in no host array and in no device block."""
        live = np.flatnonzero(self._alive)
        vecs = np.ascontiguousarray(self._vecs[live])
        keys = [self._keys[i] for i in live]
        enc = (np.ascontiguousarray(self._enc[live])
               if self._enc is not None else None)
        scales = (np.ascontiguousarray(self._scales[live])
                  if self._scales is not None else None)
        self._reset_layout(vecs, keys, np.ones(live.size, bool),
                           enc=enc, scales=scales)

    def _reset_layout(self, vecs: np.ndarray, keys: list[str],
                      alive: np.ndarray, enc: np.ndarray | None = None,
                      scales: np.ndarray | None = None) -> None:
        """Adopt canonical arrays and re-derive placement from scratch
        (compaction and restore land here)."""
        self._vecs = np.asarray(vecs, np.float32)
        if self._enc is not None:
            if enc is None:
                raise ValueError(
                    f"{self.codec.name} rows need their encoded arrays; "
                    "got fp32-only state (cross-dtype restore?)")
            self._enc = np.asarray(enc, self.codec.enc_dtype)
        if self._scales is not None:
            self._scales = np.asarray(scales, np.float32)
        if self._vecs.shape[1]:
            self.dim = int(self._vecs.shape[1])
        self._keys = list(keys)
        self._alive = np.asarray(alive, bool).copy()
        self._key2row = {k: i for i, k in enumerate(self._keys)
                         if self._alive[i]}
        n = len(self._keys)
        self._row_shard = np.full(n, -1, np.int32)
        self._row_slot = np.full(n, -1, np.int32)
        self._slots = [[] for _ in range(self.n_shards)]
        self._free = [[] for _ in range(self.n_shards)]
        for row in range(n):
            if not self._alive[row]:
                continue                 # dead rows own no slot
            shard = shard_of_key(self._keys[row], self.n_shards)
            self._row_shard[row] = shard
            self._row_slot[row] = self._claim_slot(shard, row)
        self._invalidate()

    def restore(self, vecs: np.ndarray, keys: list[str],
                alive: np.ndarray) -> None:
        """Inverse of the canonical accessors for fp32 rows; placement is
        re-derived."""
        if self.codec.lossy:
            raise ValueError(
                f"{self.codec.name} rows restore from encoded state "
                "(restore_encoded); got fp32-only state — the store was "
                "written by a different storage dtype")
        self._reset_layout(vecs, keys, alive)

    def restore_encoded(self, enc: np.ndarray, scales: np.ndarray | None,
                        keys: list[str], alive: np.ndarray) -> None:
        """Adopt snapshotted encoded rows (+ scales) as canonical and
        re-derive the fp32 side by decoding — the encoded array is never
        re-derived, so restore is bit for bit."""
        enc = self.codec.from_storage(enc)
        self._reset_layout(self.codec.decode(enc, scales), keys, alive,
                           enc=enc, scales=scales)

    # --------------------------------------------------------------- pack
    def pack(self):
        """(Re)build the device ``FlatIndex`` over the live rows: fp32
        rows normalized for cosine (``FlatIndex.build``) unless the
        substrate takes them as they come, lossy rows as their encoded
        bytes + scale column."""
        live = np.flatnonzero(self._alive)
        if live.size == 0:
            raise ValueError("index is empty")
        if self._flat is None:
            from repro_torch.core.flat import FlatIndex
            self._live_rows = live
            if self.codec.lossy:
                self._flat = FlatIndex(
                    vectors=device_rows(self._enc[live], self.device),
                    metric=self.metric,
                    scales=(device_rows(self._scales[live], self.device)
                            if self._scales is not None else None))
            elif self.normalize_on_pack:
                self._flat = FlatIndex.build(self._vecs[live],
                                             metric=self.metric,
                                             device=self.device)
            else:
                self._flat = FlatIndex(
                    vectors=device_rows(self._vecs[live], self.device),
                    metric=self.metric)
        return self._flat

    # -------------------------------------------------------------- search
    def topk(self, queries: np.ndarray, k: int
             ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over live rows (asymmetric under a lossy codec:
        fp32 query vs encoded rows) -> (dists, global row ids) with
        ``min(k, live)`` columns — callers pad."""
        flat = self.pack()
        d, i = flat.query(np.asarray(queries, np.float32), min(k, flat.n))
        return d.cpu().numpy(), self._live_rows[i.cpu().numpy()]

    def rerank_topk(self, queries: np.ndarray, gids: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact fp32 re-scoring of over-fetched candidates against the
        canonical host rows: the second half of the lossy search."""
        return rerank_exact(self._vecs, queries, gids, k,
                            metric=self.metric)

    def device_block_bytes(self) -> int:
        """Bytes the packed device representation holds for the current
        live set (rows + scale table): the codec's device footprint."""
        packed = self.pack()
        total = packed.vectors.numel() * packed.vectors.element_size()
        if packed.scales is not None:
            total += packed.scales.numel() * packed.scales.element_size()
        return total
