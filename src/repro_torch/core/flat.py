"""Exact flat index: brute-force top-k (the recall oracle and the flat
backend), ported from ``repro/core/flat.py``.

Search goes through ``kernels.ops.flat_topk``: the ``distance_topk`` CUDA
kernel for tensors on the card, its plain PyTorch version on the CPU.

  * ``FlatIndex`` — rows as tensors on one device (the oracle that
    ``HNSW.exact_query`` and ``FlatVectorIndex`` call into);
  * ``FlatVectorIndex`` — the keyed, mutable ``VectorIndex`` backend on
    the ``ShardedRows`` substrate: mutations mark the device rows stale
    and the next query re-packs once. At ``n_shards > 1`` every shard
    scans its own block on its own device and the per-shard top-k merge
    through the tree; the keys and ``state_dict`` do not depend on the
    shard count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codec import (check_codec_arrays, device_rows,
                                    effective_rerank, get_codec)
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.core.index import VectorIndex
from repro_torch.core.sharded import ShardedRows
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class FlatIndex:
    vectors: torch.Tensor       # [N, D] (normalised if cosine); f32, or
                                # codec-encoded bf16 / int8
    metric: str = "cosine"
    scales: torch.Tensor | None = None   # [N] per-row decode scales (int8)

    @classmethod
    def build(cls, vectors, metric: str = "cosine",
              device=None) -> "FlatIndex":
        """fp32 rows (normalized here for cosine) on ``device`` (default
        cuda)."""
        v = np.asarray(vectors, np.float32)
        if metric == "cosine":
            v = normalize_rows(v)
        return cls(vectors=device_rows(v, resolve_device(device)),
                   metric=metric)

    def query(self, queries, k: int = 10):
        """queries [B, D] (or [D]) -> (dists, row ids) tensors on the
        index's device, ``k`` columns ascending by (d, id)."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.vectors.device)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None]
        if self.metric == "cosine":
            q = q / torch.clamp_min(
                torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
        d, i = ops.flat_topk(self.vectors, q.contiguous(), k,
                             metric=self.metric, scales=self.scales)
        if squeeze:
            return d[0], i[0]
        return d, i

    @property
    def n(self) -> int:
        return self.vectors.shape[0]


def _pad_results(keys: list[list], d: np.ndarray, k: int
                 ) -> tuple[list[list], np.ndarray]:
    """Protocol shape contract: k > live pads keys with None, dists with
    INF, so every backend returns exactly k slots."""
    short = k - d.shape[1]
    if short <= 0:
        return keys, d
    keys = [row + [None] * short for row in keys]
    d = np.concatenate(
        [d, np.full((d.shape[0], short), np.float32(3e38))], axis=1)
    return keys, d


class FlatVectorIndex(VectorIndex):
    """Mutable keyed flat index. Exact by construction, so
    ``query`` and ``exact_query`` coincide.

    ``dtype`` picks the row codec (fp32 | bf16 | int8): the device holds
    the encoded rows; lossy searches run the asymmetric scan (fp32 query
    vs encoded rows), over-fetch ``k·rerank_factor`` candidates, and
    rerank exactly in fp32 from the canonical host rows.
    """

    kind = "flat"

    def __init__(self, *, metric: str = "cosine", dim: int | None = None,
                 n_shards: int = 1, dtype: str = "fp32",
                 rerank_factor: int | None = None, device=None):
        if metric not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.dim = dim
        self.n_shards = int(n_shards)
        self.dtype = str(dtype)
        self.rerank_factor = rerank_factor
        self._codec = get_codec(self.dtype)
        self._rows = ShardedRows(n_shards=self.n_shards, metric=metric,
                                 dim=dim, codec=self._codec, device=device)

    # ------------------------------------------------------------ mutation
    def _insert_impl(self, key: str, value: np.ndarray) -> None:
        self._rows.upsert(key, np.asarray(value, np.float32).reshape(-1))
        self.dim = self._rows.dim
        self._bump_epoch()

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
        self._rows.upsert_many(keys, values)
        self.dim = self._rows.dim
        self._bump_epoch()

    def _update_impl(self, key: str, value: np.ndarray) -> None:
        self._insert_impl(key, value)

    def _delete_impl(self, key: str) -> None:
        self._rows.tombstone(key)
        self._bump_epoch()

    def _compact_impl(self) -> None:
        """Physically drop tombstoned rows: live rows re-pack
        contiguously on the host, and the next search re-packs the
        device rows from them."""
        self._rows.compact()
        self._bump_epoch()

    # --------------------------------------------------------------- query
    def query_batch(self, queries, k: int = 10, **kw):
        """ONE device search for the whole [B, D] batch. Under a lossy
        codec the scan over-fetches ``k·rerank_factor`` candidates and
        reranks exactly in fp32 from the canonical host rows."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        rf = effective_rerank(self._codec, self.rerank_factor)
        if rf <= 1:
            d, rows = self._rows.topk(q, k)
        else:
            _, cand = self._rows.topk(q, k * rf)
            d, rows = self._rows.rerank_topk(q, cand, k)
        keys = [[self._rows.key_of_row(int(r)) if r >= 0 else None
                 for r in row] for row in rows]
        return _pad_results(keys, d, k)

    def exact_query(self, query, k: int = 10):
        return self.query(query, k)        # flat IS the brute-force oracle

    # --------------------------------------------------------- persistence
    # Canonical state only: placement is derived from the keys. Under a
    # lossy codec the persisted rows are the ENCODED bytes + scales; the
    # fp32 side is their exact decode, so restore stays bit for bit.
    def config_dict(self) -> dict:
        return {"metric": self.metric, "dim": self.dim,
                "n_shards": self.n_shards, "dtype": self.dtype,
                "rerank_factor": self.rerank_factor}

    def state_dict(self) -> tuple[dict, dict]:
        if self._codec.lossy:
            arrays = {"vectors_enc":
                      self._codec.to_storage(self._rows.encoded),
                      "alive": self._rows.alive}
            if self._rows.scales is not None:
                arrays["scales"] = self._rows.scales
        else:
            arrays = {"vectors": self._rows.vectors,
                      "alive": self._rows.alive}
        meta = {"keys": list(self._rows.key_list), "epoch": self._epoch}
        return arrays, meta

    def restore_state(self, arrays: dict, meta: dict) -> None:
        check_codec_arrays(self._codec, arrays, self.kind)
        if self._codec.lossy:
            self._rows.restore_encoded(arrays["vectors_enc"],
                                       arrays.get("scales"),
                                       list(meta["keys"]),
                                       np.asarray(arrays["alive"], bool))
        else:
            self._rows.restore(np.asarray(arrays["vectors"], np.float32),
                               list(meta["keys"]),
                               np.asarray(arrays["alive"], bool))
        if self._rows.dim:
            self.dim = self._rows.dim
        self._epoch = int(meta["epoch"])

    def _row_count(self) -> int:
        return self._rows.row_count

    @property
    def size(self) -> int:
        return self._rows.size

    def _contains(self, key: str) -> bool:
        return self._rows.contains(key)

    def keys(self) -> list[str]:
        return self._rows.live_keys()

    @property
    def shard_count(self) -> int:
        return self.n_shards

    def shard_stats(self) -> list[dict]:
        return self._rows.shard_stats()
