"""IVF-Flat index, ported from ``repro/core/ivf.py``.

Build: a few Lloyd iterations of k-means -> ``nlist`` fp32 centroids;
rows go into fixed-capacity inverted lists (padded, -1). Search: score the
queries against the centroids (one ``gather_distance`` launch, K = nlist),
take the ``nprobe`` nearest lists, gather their rows and score them (a
second launch, K = nprobe · cap, decoding bf16/int8 rows in the kernel),
exact top-k over the candidates. Both selections are a stable sort, so
equal distances keep the lower slot first, as ``lax.top_k`` does.

``kmeans`` runs in plain PyTorch on the rows' device (the reference keeps
it in jnp, not Pallas): fp32 products with TF32 off, ``argmin``, and the
per-cluster sums as the one-hot product ``onehot(assign)ᵀ @ x``, which has
no float atomics, so two runs on the card train the same centroids bit
for bit. Its initial rows are drawn by a seeded CPU ``torch.Generator``
(``init_rows``; the reference draws with ``jax.random.choice``, and
``init`` lets a caller give both the same start).

At ``n_shards > 1`` the rows live in ``ShardedRows``' per-shard blocks and
the centroids stay global (canonical state, so ``state_dict`` does not
depend on the shard count). Each shard packs inverted lists over its own
slots. A search scores the centroids once a distinct shard device (every
shard probes the same lists), gathers each shard's own members with the
hop kernel (K = nprobe · that shard's cap), masks and trims to k, and
merges the shards through the tree (``distributed/collectives.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codec import (check_codec_arrays, device_rows,
                                    effective_rerank, get_codec)
from repro_torch.core.flat import _pad_results
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.core.index import VectorIndex
from repro_torch.core.sharded import (ExactBlocks, ShardedRows, normalized,
                                      per_device, resolve_wire_bf16,
                                      trim_merge_width)
from repro_torch.distributed.collectives import hierarchical_topk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k
from repro_torch.utils import resolve_device

INF = 3.0e38                  # == the reference's empty-slot distance


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    vectors: torch.Tensor     # [N, D] (normalised if cosine); f32, or
                              # codec-encoded bf16 / int8
    centroids: torch.Tensor   # [nlist, D] always fp32 (trained state)
    lists: torch.Tensor       # [nlist, cap] int32, -1 padded
    metric: str
    scales: torch.Tensor | None = None   # [N] per-row decode scales (int8)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]


def _assign(x: torch.Tensor, xx: torch.Tensor,
            cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (the reference's expanded l2, lowest
    index among ties). Doubling the product instead of the rows is
    exact, so this is the reference's ``2 * x @ cent.T``."""
    d = (xx[:, None] - 2 * (x @ cent.T)) + (cent * cent).sum(1)[None, :]
    return torch.argmin(d, 1)


def init_rows(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct row indices of n, drawn by a CPU ``torch.Generator``
    seeded with ``seed``, so the draw does not depend on the device."""
    return torch.randperm(
        n, generator=torch.Generator().manual_seed(int(seed)))[:k]


def kmeans(x: torch.Tensor, k: int, iters: int = 8, seed: int = 0,
           init=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on x [N, D] f32 (on its device) -> (centroids
    [k, D] f32, assignment [N] int64). ``init``: k row indices to start
    from; by default ``init_rows(N, k, seed)``. An empty cluster keeps
    its centroid."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("kmeans needs full-fp32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    x = x.float().contiguous()
    n = x.shape[0]
    if init is None:
        init = init_rows(n, k, seed)
    if not isinstance(init, torch.Tensor):
        init = torch.from_numpy(np.array(init, np.int64))
    init = init.long()
    cent = x[init.to(x.device)]
    xx = (x * x).sum(1)
    for _ in range(iters):
        assign = _assign(x, xx, cent)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        sums = onehot.T @ x
        cnt = torch.bincount(assign, minlength=k).to(x.dtype)[:, None]
        cent = torch.where(cnt > 0, sums / torch.clamp_min(cnt, 1), cent)
        del onehot, sums
    return cent, _assign(x, xx, cent)


def _lists(assign: np.ndarray, nlist: int,
           values: np.ndarray | None = None) -> np.ndarray:
    """Inverted lists [nlist, cap] int32, -1 padded: each cluster's
    members in ascending member order (a stable sort of the assignment),
    a member ``j`` stored as ``values[j]`` (default: ``j``)."""
    assign = np.asarray(assign, np.int64)
    counts = np.bincount(assign, minlength=nlist)
    cap = max(int(counts.max()), 1)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(order.size) - starts[assign[order]]
    lists = np.full((nlist, cap), -1, np.int32)
    lists[assign[order], slot] = order if values is None else values[order]
    return lists


def build_ivf(vectors, *, nlist: int = 64, metric: str = "cosine",
              iters: int = 8, seed: int = 0, init=None,
              device=None) -> IVFIndex:
    """An fp32 ``IVFIndex`` over ``vectors`` (normalized for cosine) on
    ``device`` (default cuda)."""
    device = resolve_device(device)
    v = np.asarray(vectors, np.float32)
    if metric == "cosine":
        v = normalize_rows(v)
    vt = device_rows(v, device)
    cent, assign = kmeans(vt, nlist, iters, seed, init=init)
    lists = _lists(assign.cpu().numpy(), nlist)
    return IVFIndex(vectors=vt, centroids=cent,
                    lists=torch.from_numpy(lists).to(device), metric=metric)


def _search(idx: IVFIndex, q: torch.Tensor, k: int, nprobe: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    b = q.shape[0]
    nlist, cap = idx.lists.shape
    # coarse: every centroid of every query, then the nprobe nearest
    coarse = torch.arange(nlist, dtype=torch.int32,
                          device=q.device).expand(b, nlist).contiguous()
    cd = ops.gather_distance(idx.centroids, q, coarse, metric=idx.metric)
    _, probe = smallest_k(cd, coarse, nprobe)                # [B, nprobe]
    cand = torch.index_select(idx.lists, 0, probe.reshape(-1).long()
                              ).reshape(b, nprobe * cap)
    valid = cand >= 0
    ids = torch.clamp(cand, 0, idx.n - 1)
    d = ops.gather_distance(idx.vectors, q, ids, metric=idx.metric,
                            scales=idx.scales)
    d = torch.where(valid, d, INF)
    d, out_ids = smallest_k(d, ids, k)
    # list-padding slots that reached the top-k (fewer live candidates
    # than k) must not leak a clipped row id: mark them missing
    return torch.where(d >= INF, -1, out_ids), d


def search_ivf(idx: IVFIndex, queries, k: int = 10, nprobe: int = 8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [B, D] (or [D]) -> (ids [B, k] int32, -1 for a missing
    slot; dists [B, k] f32, INF there) on the index's device, ascending by
    (d, candidate slot). ``nprobe`` is clamped to nlist and ``k`` to the
    nprobe · cap candidates the probed lists expose."""
    q = torch.as_tensor(np.asarray(queries, np.float32),
                        device=idx.vectors.device)
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None]
    if idx.metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    q = q.contiguous()
    nprobe = min(nprobe, idx.centroids.shape[0])
    k = min(k, nprobe * idx.lists.shape[1])
    ids, dists = _search(idx, q, k, nprobe)
    if squeeze:
        return ids[0], dists[0]
    return ids, dists


@dataclasses.dataclass(frozen=True)
class ShardedIVF:
    """The per-shard packed state of a sharded IVF index: the rows
    (``ShardedRows.pack()``), each shard's lists [nlist, cap_s] of its
    own slots on its device, and the fp32 centroids on every distinct
    shard device."""
    placed: ExactBlocks        # the rows, a block a shard
    lists: list                # [nlist, cap_s] int32 a shard, -1 padded
    centroids: dict            # device -> [nlist, D] f32
    nlist: int
    cap_global: int            # the 1-shard index's cap: the same k clamp
    n_live: int


def ivf_fanout(sp: ShardedIVF, q: torch.Tensor, k: int, nprobe: int, *,
               metric: str, wire_bf16: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prepared queries [B, D] -> (dists [B, k], gids [B, k]) on the first
    shard's device, missing slots (INF, -1). The coarse launch (K =
    nlist) runs once a distinct shard device, and every shard probes the
    lists it picks; each shard's fine launch (K = nprobe · cap_s) scores
    its own members, which are masked, trimmed to k and merged. No host
    read until the merge's result is read."""
    devices = sp.placed.devices
    qs = per_device(q, devices)
    probes = {}
    for dev, qd in qs.items():
        b = qd.shape[0]
        coarse = torch.arange(sp.nlist, dtype=torch.int32,
                              device=dev).expand(b, sp.nlist).contiguous()
        cd = ops.gather_distance(sp.centroids[dev], qd, coarse,
                                 metric=metric)
        probes[dev] = smallest_k(cd, coarse, nprobe)[1].reshape(-1).long()
    parts = []
    for s, (blk, gid, lists) in enumerate(zip(sp.placed.blocks,
                                              sp.placed.gids, sp.lists)):
        qd = qs[blk.device]
        b = qd.shape[0]
        cand = torch.index_select(lists, 0, probes[blk.device]).reshape(
            b, nprobe * lists.shape[1])
        slots = torch.clamp(cand, 0, blk.shape[0] - 1)
        d = ops.gather_distance(blk, qd, slots, metric=metric,
                                scales=None if sp.placed.scales is None
                                else sp.placed.scales[s])
        d = torch.where(cand >= 0, d, INF)
        d, g = trim_merge_width(d, gid[slots.long()], k)
        parts.append((d, torch.where(d >= INF, -1, g)))
    return hierarchical_topk(parts, k, wire_bf16=wire_bf16,
                             tie_break_ids=True)


class IVFVectorIndex(VectorIndex):
    """Keyed mutable IVF backend.

    Centroids are trained once (k-means over the rows present at the first
    query); later inserts are assigned to their nearest existing centroid
    on the host, in numpy. Deletes drop the row from its inverted list at
    the next pack. The packed device index is rebuilt lazily after
    mutations.

    Training happens at query time, outside the mutation history, so with
    a store attached it logs a ``derived.centroids`` WAL record; replay
    lands on the same centroids, keeping a warm restore bit for bit.

    With ``n_shards > 1`` storage and routing live in ``ShardedRows``; the
    centroids stay global while each shard packs inverted lists over its
    own rows and searches them on its own device.
    """

    kind = "ivf"

    def __init__(self, *, metric: str = "cosine", dim: int | None = None,
                 nlist: int = 64, nprobe: int = 8, iters: int = 8,
                 seed: int = 0, n_shards: int = 1, dtype: str = "fp32",
                 rerank_factor: int | None = None, device=None):
        if metric not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.dim = dim
        self.nlist = nlist
        self.nprobe = nprobe
        self.iters = iters
        self.seed = seed
        self.n_shards = int(n_shards)
        self.dtype = str(dtype)
        self.rerank_factor = rerank_factor
        self.device = resolve_device(device)
        self._codec = get_codec(self.dtype)
        # rows are normalized at INSERT time for cosine, so the substrate
        # takes them as they come (a lossy codec encodes them once)
        self._rows = ShardedRows(n_shards=self.n_shards, metric=metric,
                                 dim=dim, normalize_on_pack=False,
                                 codec=self._codec, device=self.device)
        self._centroids: np.ndarray | None = None   # trained lazily
        self._idx: IVFIndex | None = None           # S == 1 packed index
        self._live_rows: np.ndarray | None = None   # S == 1 pack order
        self._spack: ShardedIVF | None = None       # S > 1 packed shards

    # ------------------------------------------------------------ mutation
    def _invalidate(self) -> None:
        self._idx = None
        self._live_rows = None
        self._spack = None

    def _insert_impl(self, key: str, value: np.ndarray) -> None:
        v = np.asarray(value, np.float32).reshape(-1)
        if self.metric == "cosine":
            v = v / max(float(np.linalg.norm(v)), 1e-12)
        self._rows.upsert(key, v)
        self.dim = self._rows.dim
        self._invalidate()
        self._bump_epoch()

    def _bulk_insert_impl(self, keys: list[str], values: np.ndarray) -> None:
        values = np.asarray(values, np.float32)
        if self.metric == "cosine":
            values = normalize_rows(values)
        self._rows.upsert_many(keys, values)
        self.dim = self._rows.dim
        self._invalidate()
        self._bump_epoch()

    def _update_impl(self, key: str, value: np.ndarray) -> None:
        self._insert_impl(key, value)

    def _delete_impl(self, key: str) -> None:
        self._rows.tombstone(key)
        self._invalidate()
        self._bump_epoch()

    def _compact_impl(self) -> None:
        """Physically drop tombstoned rows. The centroids go too (a
        singleton cluster's centroid IS its row) and retrain over the live
        rows at the next pack."""
        self._rows.compact()
        self._centroids = None
        self._invalidate()
        self._bump_epoch()

    # ----------------------------------------------------------- training
    def _coarse(self, live: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        """-> (centroids, assignment over live rows, nlist)."""
        v = self._rows.vectors[live]
        nlist = min(self.nlist, live.size)
        if self._centroids is None or self._centroids.shape[0] != nlist:
            cent, assign = kmeans(device_rows(v, self.device), nlist,
                                  self.iters, self.seed)
            self._centroids = cent.cpu().numpy()
            assign = assign.cpu().numpy()
            if self._store is not None:
                self._store.wal_append("derived.centroids",
                                       epoch=self._epoch, meta={},
                                       arrays={"centroids": self._centroids})
        else:
            d = (np.sum(v * v, 1)[:, None] - 2 * v @ self._centroids.T
                 + np.sum(self._centroids ** 2, 1)[None, :])
            assign = np.argmin(d, 1)
        return self._centroids, assign, nlist

    # --------------------------------------------------------------- query
    def _pack(self) -> IVFIndex:
        """(Re)build the padded lists over live rows only, on the device:
        lossy rows as their encoded bytes (+ scales), decoded in the
        kernel."""
        if self._idx is not None:
            return self._idx
        live = np.flatnonzero(self._rows.alive)
        if live.size == 0:
            raise ValueError("index is empty")
        self._live_rows = live
        cent, assign, nlist = self._coarse(live)
        lists = _lists(assign, nlist)
        if self._codec.lossy:
            vecs = device_rows(self._rows.encoded[live], self.device)
            scl = (device_rows(self._rows.scales[live], self.device)
                   if self._rows.scales is not None else None)
        else:
            vecs, scl = device_rows(self._rows.vectors[live],
                                    self.device), None
        self._idx = IVFIndex(vectors=vecs,
                             centroids=device_rows(cent, self.device),
                             lists=torch.from_numpy(lists).to(self.device),
                             metric=self.metric, scales=scl)
        return self._idx

    def _pack_sharded(self) -> ShardedIVF:
        """(Re)build the per-shard inverted lists: every live row's slot
        joins its cluster's list on its owning shard, in row order (the
        reference's loop)."""
        if self._spack is not None:
            return self._spack
        live = np.flatnonzero(self._rows.alive)
        if live.size == 0:
            raise ValueError("index is empty")
        placed = self._rows.pack()
        cent, assign, nlist = self._coarse(live)
        assign = np.asarray(assign, np.int64)
        shard = self._rows._row_shard[live]
        slot = self._rows._row_slot[live]
        lists = []
        for s, dev in enumerate(placed.devices):
            mine = np.flatnonzero(shard == s)
            lists.append(torch.from_numpy(
                _lists(assign[mine], nlist, values=slot[mine])).to(dev))
        cap_global = max(int(np.bincount(assign, minlength=nlist).max()), 1)
        self._spack = ShardedIVF(
            placed=placed, lists=lists,
            centroids={dev: device_rows(cent, dev)
                       for dev in dict.fromkeys(placed.devices)},
            nlist=nlist, cap_global=cap_global, n_live=int(live.size))
        return self._spack

    def probe_plan(self, nprobe: int | None = None) -> dict:
        """The packed index's shape: nlist, list cap, nprobe and the fine
        launch's K (nprobe · cap candidates a query); sharded, the largest
        shard's cap and K, with each shard's caps."""
        if self.n_shards > 1:
            sp = self._pack_sharded()
            caps = [int(li.shape[1]) for li in sp.lists]
            npr = min(nprobe or self.nprobe, sp.nlist)
            return {"nlist": sp.nlist, "cap": max(caps), "nprobe": npr,
                    "probe_k": npr * max(caps), "shard_caps": caps}
        nlist, cap = self._pack().lists.shape
        npr = min(nprobe or self.nprobe, nlist)
        return {"nlist": nlist, "cap": cap, "nprobe": npr,
                "probe_k": npr * cap}

    def query_batch(self, queries, k: int = 10, nprobe: int | None = None,
                    **kw):
        """One probed search for the whole [B, D] batch. Under a lossy
        codec it over-fetches ``k·rerank_factor`` candidates and reranks
        them exactly in fp32 from the canonical host rows. Other
        backends' knobs (hnsw's ``ef``) are accepted and ignored."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        rf = effective_rerank(self._codec, self.rerank_factor)
        if self.n_shards > 1:
            return self._query_batch_sharded(q, k, rf, nprobe)
        idx = self._pack()
        ids, d = search_ivf(idx, q, k=min(k * rf, idx.n),
                            nprobe=nprobe or self.nprobe)
        ids, d = ids.cpu().numpy(), d.cpu().numpy()
        if rf > 1:
            gids = np.where(ids >= 0, self._live_rows[ids], -1)
            d, gids = self._rows.rerank_topk(q, gids, k)
            return _pad_results(
                [[self._rows.key_of_row(int(r)) if r >= 0 else None
                  for r in row] for row in gids], d, k)
        return _pad_results(
            [[self._rows.key_of_row(int(self._live_rows[j]))
              if j >= 0 else None for j in row] for row in ids], d, k)

    def _query_batch_sharded(self, q: np.ndarray, k: int, rf: int,
                             nprobe: int | None):
        sp = self._pack_sharded()
        qt = torch.as_tensor(q, device=sp.placed.devices[0])
        if self.metric == "cosine":
            qt = normalized(qt)
        npr = min(nprobe or self.nprobe, sp.nlist)
        # the candidate-capacity clamp of the 1-shard path
        k_eff = min(min(k * rf, sp.n_live), npr * sp.cap_global)
        d, g = ivf_fanout(sp, qt.contiguous(), k_eff, npr,
                          metric=self.metric,
                          wire_bf16=resolve_wire_bf16(None))
        d, g = d.cpu().numpy(), g.cpu().numpy()
        if rf > 1:
            d, g = self._rows.rerank_topk(q, g, k)
        return _pad_results(
            [[self._rows.key_of_row(int(r)) if r >= 0 else None
              for r in row] for row in g], d, k)

    def exact_query(self, query, k: int = 10):
        # nprobe = nlist probes every list -> exact over the live set
        nlist = (self._pack_sharded().nlist if self.n_shards > 1
                 else self._pack().centroids.shape[0])
        return self.query(query, k, nprobe=nlist)

    # --------------------------------------------------------- persistence
    # Canonical state only: rows + tombstones + keys + the centroids; the
    # lists are derived at pack time.
    def config_dict(self) -> dict:
        return {"metric": self.metric, "dim": self.dim, "nlist": self.nlist,
                "nprobe": self.nprobe, "iters": self.iters,
                "seed": self.seed, "n_shards": self.n_shards,
                "dtype": self.dtype, "rerank_factor": self.rerank_factor}

    def state_dict(self) -> tuple[dict, dict]:
        cent = (self._centroids if self._centroids is not None
                else np.zeros((0, self.dim or 0), np.float32))
        if self._codec.lossy:
            arrays = {"vectors_enc":
                      self._codec.to_storage(self._rows.encoded),
                      "alive": self._rows.alive, "centroids": cent}
            if self._rows.scales is not None:
                arrays["scales"] = self._rows.scales
        else:
            arrays = {"vectors": self._rows.vectors,
                      "alive": self._rows.alive, "centroids": cent}
        meta = {"keys": list(self._rows.key_list), "epoch": self._epoch,
                "has_centroids": self._centroids is not None}
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
        self._centroids = (np.asarray(arrays["centroids"], np.float32)
                           if meta["has_centroids"] else None)
        self._epoch = int(meta["epoch"])
        self._invalidate()

    def _apply_derived(self, op: str, meta: dict, arrays: dict) -> None:
        if op != "derived.centroids":
            raise ValueError(f"IVFVectorIndex cannot replay {op!r}")
        self._centroids = np.asarray(arrays["centroids"], np.float32)
        self._invalidate()

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
