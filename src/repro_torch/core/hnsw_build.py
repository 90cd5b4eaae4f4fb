"""HNSW construction, ported from ``repro/core/hnsw_build.py``.

Two builders, both emitting the same dense ``HNSWGraph``:

* ``SequentialBuilder`` — a faithful Malkov & Yashunin (Alg. 1-4, incl.
  the neighbor-selection heuristic) in numpy: the mutable host graph
  behind ``core/interface.py:HNSW`` and the recall reference. It is a copy
  of the reference's numpy builder, so a graph built from the same rows
  and seed is bit-identical in both packages.

* ``bulk_build`` — batched lock-step inserts against ONE resident
  ``DeviceGraph``: levels drawn up front from the same numpy stream, a
  sequential bootstrap prefix, then per batch one ``search_graph`` over
  the resident graph (``gather_distance`` + ``beam_search`` on the card),
  the batched ``select_neighbors`` op for forward edges, a grouped
  reciprocal connect, and an adjacency-only device sync.

``bulk_build_legacy``, the builder ``bulk_build`` replaced, stays as the
build benchmark's baseline: a full graph upload and per-node host
connect loops every batch.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.utils import resolve_device


# ---------------------------------------------------------------------------
# Graph container (numpy; uploaded by repro_torch.core.hnsw)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HNSWGraph:
    vectors: np.ndarray          # [N, D] (normalised if cosine)
    neighbors0: np.ndarray       # [N, 2M] int32, -1 padded (layer 0)
    upper: np.ndarray            # [L_max, N, M] int32, -1 padded (layers 1..)
    levels: np.ndarray           # [N] int32
    entry: int
    max_level: int
    metric: str = "cosine"
    n: int = 0                   # number of live rows (<= capacity)

    @property
    def M(self) -> int:
        return self.upper.shape[2] if self.upper.shape[0] else self.neighbors0.shape[1] // 2

    def memory_bytes(self) -> dict:
        return {
            "vectors (slow tier)": self.vectors.nbytes,
            "graph (fast tier)": self.neighbors0.nbytes + self.upper.nbytes
                                  + self.levels.nbytes,
        }


def normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _prep(vectors: np.ndarray, metric: str) -> np.ndarray:
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    if metric == "cosine":
        v = normalize_rows(v)
    return v


def _dist(metric: str, q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """q [D], x [K, D] -> [K]. cosine assumes pre-normalised rows."""
    if metric in ("cosine", "ip"):
        return 1.0 - x @ q
    d = x - q[None, :]
    return np.einsum("kd,kd->k", d, d)


# ---------------------------------------------------------------------------
# Faithful sequential builder (Malkov & Yashunin)
# ---------------------------------------------------------------------------
class SequentialBuilder:
    def __init__(self, dim: int, *, M: int = 16, ef_construction: int = 200,
                 metric: str = "cosine", capacity: int = 1024,
                 max_level_cap: int = 12, seed: int = 0):
        self.dim = dim
        self.M = M
        self.m_max0 = 2 * M
        self.efc = ef_construction
        self.metric = metric
        self.mL = 1.0 / np.log(M) if M > 1 else 1.0
        self.max_level_cap = max_level_cap
        self.rng = np.random.default_rng(seed)
        self.n = 0
        self.entry = -1
        self.max_level = -1
        cap = max(capacity, 8)
        self.vectors = np.zeros((cap, dim), np.float32)
        self.levels = np.zeros(cap, np.int32)
        self.neighbors0 = np.full((cap, self.m_max0), -1, np.int32)
        self.upper = np.full((max_level_cap, cap, M), -1, np.int32)
        # dirty-row journal: ids whose row data (vector / adjacency / level)
        # changed since the consumer last synced. Drives the incremental
        # device-graph upload (DESIGN.md §3); consumers clear it after sync.
        self.journal: set[int] = set()

    @classmethod
    def from_graph(cls, g: HNSWGraph, *, ef_construction: int = 200,
                   max_level_cap: int = 12, seed: int = 0
                   ) -> "SequentialBuilder":
        """Adopt an existing graph (e.g. from ``bulk_build``) as mutable
        builder state, so later inserts APPEND instead of replacing it."""
        n = g.n
        b = cls(g.vectors.shape[1], M=g.M, ef_construction=ef_construction,
                metric=g.metric, capacity=max(n, 8),
                max_level_cap=max_level_cap, seed=seed)
        b.vectors[:n] = g.vectors[:n]
        b.levels[:n] = g.levels[:n]
        b.neighbors0[:n] = g.neighbors0[:n]
        b.upper[: g.upper.shape[0], :n] = g.upper[:, :n]
        b.n = n
        b.entry = int(g.entry)
        b.max_level = int(g.max_level)
        return b

    # -- storage helpers ----------------------------------------------------
    def _grow(self, need: int):
        cap = self.vectors.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2)
        self.vectors = np.concatenate(
            [self.vectors, np.zeros((new - cap, self.dim), np.float32)])
        self.levels = np.concatenate([self.levels, np.zeros(new - cap, np.int32)])
        self.neighbors0 = np.concatenate(
            [self.neighbors0, np.full((new - cap, self.m_max0), -1, np.int32)])
        self.upper = np.concatenate(
            [self.upper, np.full((self.max_level_cap, new - cap, self.M), -1,
                                 np.int32)], axis=1)

    def _nbrs(self, node: int, layer: int) -> np.ndarray:
        row = self.neighbors0[node] if layer == 0 else self.upper[layer - 1, node]
        return row[row >= 0]

    def _set_nbrs(self, node: int, layer: int, ids: np.ndarray):
        cap = self.m_max0 if layer == 0 else self.M
        row = np.full(cap, -1, np.int32)
        row[: len(ids)] = ids[:cap]
        if layer == 0:
            self.neighbors0[node] = row
        else:
            self.upper[layer - 1, node] = row
        self.journal.add(int(node))

    # -- Alg. 2: greedy ef-search on one layer -------------------------------
    def _search_layer(self, q: np.ndarray, eps: list[int], ef: int,
                      layer: int) -> list[tuple[float, int]]:
        visited = set(eps)
        d0 = _dist(self.metric, q, self.vectors[eps])
        cand = [(d, e) for d, e in zip(d0, eps)]          # min-heap
        heapq.heapify(cand)
        res = [(-d, e) for d, e in zip(d0, eps)]          # max-heap (neg)
        heapq.heapify(res)
        while cand:
            d_c, c = heapq.heappop(cand)
            if d_c > -res[0][0] and len(res) >= ef:
                break
            nbrs = [x for x in self._nbrs(c, layer) if x not in visited]
            if not len(nbrs):
                continue
            visited.update(int(x) for x in nbrs)
            dists = _dist(self.metric, q, self.vectors[nbrs])
            for d, e in zip(dists, nbrs):
                if len(res) < ef or d < -res[0][0]:
                    heapq.heappush(cand, (d, int(e)))
                    heapq.heappush(res, (-d, int(e)))
                    if len(res) > ef:
                        heapq.heappop(res)
        out = sorted([(-nd, e) for nd, e in res])
        return out[:ef]

    # -- Alg. 4: neighbor-selection heuristic --------------------------------
    def _select_heuristic(self, q: np.ndarray, cand: list[tuple[float, int]],
                          m: int) -> np.ndarray:
        cand = sorted(cand)
        selected: list[tuple[float, int]] = []
        for d_q, e in cand:
            if len(selected) >= m:
                break
            ev = self.vectors[e]
            ok = True
            for _, s in selected:
                if _dist(self.metric, ev, self.vectors[s][None])[0] < d_q:
                    ok = False
                    break
            if ok:
                selected.append((d_q, e))
        # backfill with pruned candidates (keepPrunedConnections=True)
        if len(selected) < m:
            chosen = {e for _, e in selected}
            for d_q, e in cand:
                if len(selected) >= m:
                    break
                if e not in chosen:
                    selected.append((d_q, e))
        return np.array([e for _, e in selected], np.int32)

    # -- Alg. 1: insert -------------------------------------------------------
    def insert(self, vec: np.ndarray, level: int | None = None,
               prenormalized: bool = False) -> int:
        # prenormalized: the caller already put ``vec`` in its final
        # stored form (metric normalization + codec quantization,
        # DESIGN.md §9) — re-normalizing here would perturb the bytes the
        # snapshot layer treats as canonical.
        self._grow(self.n + 1)
        q = np.asarray(vec, np.float32)
        if self.metric == "cosine" and not prenormalized:
            q = q / max(float(np.linalg.norm(q)), 1e-12)
        node = self.n
        self.vectors[node] = q
        if level is None:
            level = int(-np.log(self.rng.uniform(1e-12, 1.0)) * self.mL)
        lvl = min(level, self.max_level_cap)
        self.levels[node] = lvl
        self.n += 1
        self.journal.add(node)

        if self.entry < 0:
            self.entry, self.max_level = node, lvl
            return node

        ep = [self.entry]
        for lc in range(self.max_level, lvl, -1):
            ep = [self._search_layer(q, ep, 1, lc)[0][1]]
        for lc in range(min(lvl, self.max_level), -1, -1):
            w = self._search_layer(q, ep, self.efc, lc)
            m = self.m_max0 if lc == 0 else self.M
            nbrs = self._select_heuristic(q, w, self.M)
            self._set_nbrs(node, lc, nbrs)
            for e in nbrs:
                cur = self._nbrs(int(e), lc)
                if node not in cur:
                    cur = np.append(cur, node).astype(np.int32)
                if len(cur) > m:       # shrink with the same heuristic
                    ev = self.vectors[int(e)]
                    cand = list(zip(_dist(self.metric, ev, self.vectors[cur]),
                                    [int(c) for c in cur]))
                    cur = self._select_heuristic(ev, cand, m)
                self._set_nbrs(int(e), lc, cur)
            ep = [e for _, e in w]
        if lvl > self.max_level:
            self.entry, self.max_level = node, lvl
        return node

    def add_batch(self, vecs: np.ndarray):
        for v in vecs:
            self.insert(v)

    def graph(self) -> HNSWGraph:
        n = self.n
        lmax = max(int(self.levels[:n].max(initial=0)), 0)
        return HNSWGraph(
            vectors=self.vectors[:n],
            neighbors0=self.neighbors0[:n],
            upper=self.upper[:lmax, :n].copy(),
            levels=self.levels[:n],
            entry=self.entry,
            max_level=self.max_level,
            metric=self.metric,
            n=n,
        )

    def graph_full_capacity(self, lmax: int) -> HNSWGraph:
        """Fixed-shape view over the whole capacity (not-yet-inserted rows are
        unreachable); keeps batched-search shapes constant across bulk
        batches so the search jit-compiles exactly once."""
        return HNSWGraph(
            vectors=self.vectors,
            neighbors0=self.neighbors0,
            upper=self.upper[:lmax],
            levels=self.levels,
            entry=self.entry,
            max_level=self.max_level,
            metric=self.metric,
            n=self.n,
        )


def build_sequential(vectors: np.ndarray, *, M: int = 16,
                     ef_construction: int = 200, metric: str = "cosine",
                     seed: int = 0) -> HNSWGraph:
    v = _prep(vectors, metric)
    b = SequentialBuilder(v.shape[1], M=M, ef_construction=ef_construction,
                          metric=metric, capacity=len(v), seed=seed)
    b.add_batch(v)
    return b.graph()


def select_heuristic_host(metric: str, vectors: np.ndarray, q: np.ndarray,
                          cand: list[tuple[float, int]], m: int) -> np.ndarray:
    """Module-level host oracle for the batched select op (Malkov Alg. 4
    with keepPrunedConnections backfill) — the loop the vectorized
    ``kernels.ops.select_neighbors`` is pinned against. Identical to
    ``SequentialBuilder._select_heuristic`` plus keep-first dedup of
    candidate ids, which the batched reciprocal connect needs: a batch
    member can select a destination whose forward list already contains
    it, so the merged candidate row may repeat an id."""
    seen: set[int] = set()
    uniq = []
    for d_q, e in cand:
        if e not in seen:
            seen.add(e)
            uniq.append((float(d_q), int(e)))
    uniq.sort()                       # (d, id): ties break on id, as the op
    selected: list[tuple[float, int]] = []
    for d_q, e in uniq:
        if len(selected) >= m:
            break
        ev = vectors[e]
        ok = True
        for _, s in selected:
            if _dist(metric, ev, vectors[s][None])[0] < d_q:
                ok = False
                break
        if ok:
            selected.append((d_q, e))
    if len(selected) < m:             # keepPrunedConnections backfill
        chosen = {e for _, e in selected}
        for d_q, e in uniq:
            if len(selected) >= m:
                break
            if e not in chosen:
                selected.append((d_q, e))
    return np.array([e for _, e in selected], np.int32)



# ---------------------------------------------------------------------------
# Bulk builder: batched lock-step inserts against a resident device graph
# ---------------------------------------------------------------------------
def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _select_batched(dev_vectors: torch.Tensor, q: np.ndarray,
                    cand: np.ndarray, *, m: int, metric: str) -> np.ndarray:
    """Run ``ops.select_neighbors`` in row chunks on the device of
    ``dev_vectors``: q [R, D] f32, cand [R, C] i32 -1-pad -> ids [R, m]
    i32 -1-pad. The chunk bounds the op's [chunk, C, C] pairwise block to
    ~256 MB however wide the candidate lists get."""
    from repro_torch.kernels import ops

    r, c = cand.shape
    if r == 0:
        return np.zeros((0, m), np.int32)
    chunk = min(max(1 << 26 >> (2 * (max(c, 1).bit_length() - 1)), 16), 4096)
    dev = dev_vectors.device
    out = np.empty((r, m), np.int32)
    for s in range(0, r, chunk):
        e = min(s + chunk, r)
        ids, _ = ops.select_neighbors(
            dev_vectors, torch.as_tensor(q[s:e], dtype=torch.float32).to(dev),
            torch.as_tensor(cand[s:e], dtype=torch.int32).to(dev),
            m=m, metric=metric)
        out[s:e] = ids.cpu().numpy()
    return out


def _connect_reciprocal(b: SequentialBuilder, e_src: np.ndarray,
                        e_dst: np.ndarray, e_lay: np.ndarray,
                        dev_vectors: torch.Tensor | None = None,
                        impl: str = "op") -> list[int]:
    """Batched reciprocal connect: apply one batch's back-edges (src ->
    dst at layer) by DESTINATION — group the edge list with a host
    sort-segment pass, then re-select each touched row once from (current
    adjacency ∪ new sources) with the same Alg. 4 heuristic, vectorized
    over all destinations of a layer. Sources merge in ascending id order,
    so the result does not depend on how the edge list was produced.
    ``impl`` selects the vectorized op ("op", on ``dev_vectors``'s
    device) or the host-loop oracle ("host"). Returns the touched row ids
    (the adjacency-dirty set the device sync must copy)."""
    dirty: list[int] = []
    for lc in np.unique(e_lay):
        sel_m = e_lay == lc
        ordi = np.lexsort((e_src[sel_m], e_dst[sel_m]))
        dst = e_dst[sel_m][ordi]
        src = e_src[sel_m][ordi]
        udst, starts, cnts = np.unique(dst, return_index=True,
                                       return_counts=True)
        gcount = len(udst)
        gmax = int(cnts.max())
        cap = b.m_max0 if lc == 0 else b.M
        adj = (b.neighbors0[udst] if lc == 0
               else b.upper[lc - 1, udst])                  # [G, cap]
        srcs = np.full((gcount, _pow2_ceil(gmax)), -1, np.int32)
        srcs[np.repeat(np.arange(gcount), cnts),
             np.arange(len(src)) - np.repeat(starts, cnts)] = src
        cand = np.concatenate([adj, srcs], axis=1)
        if impl == "op":
            sel = _select_batched(dev_vectors, b.vectors[udst], cand,
                                  m=cap, metric=b.metric)
        else:                                     # host-loop oracle
            sel = np.full((gcount, cap), -1, np.int32)
            for gi, e in enumerate(udst):
                ids = cand[gi][cand[gi] >= 0]
                ev = b.vectors[int(e)]
                cd = list(zip(_dist(b.metric, ev, b.vectors[ids]),
                              [int(c) for c in ids]))
                keep = select_heuristic_host(b.metric, b.vectors, ev, cd, cap)
                sel[gi, : len(keep)] = keep
        if lc == 0:
            b.neighbors0[udst] = sel
        else:
            b.upper[lc - 1, udst] = sel
        dirty.extend(int(x) for x in udst)
    return dirty


def bulk_build(vectors: np.ndarray, *, M: int = 16, ef_construction: int = 200,
               metric: str = "cosine", seed: int = 0,
               bootstrap: int = 256, batch_size: int = 1024,
               prenormalized: bool = False, max_level_cap: int = 12,
               beam_impl: str = "fused", connect_impl: str = "op",
               device=None) -> HNSWGraph:
    """Device-resident bulk ingest on ``device`` (default: the card).

    Assign levels up front; bootstrap a sequential prefix; then insert
    the remainder in batches against ONE capacity-padded resident
    ``DeviceGraph``. Per batch:

      1. one ``search_graph`` finds every member's
         ``min(ef_construction, prefix)`` candidates over the prefix (the
         upper-layer hops launch ``gather_distance``, layer 0 one
         ``beam_search``); nothing re-uploads;
      2. a host self-distance block adds each member's intra-batch
         top-K, so batch members can become each other's neighbors;
      3. forward edges: every (member, layer) row goes through the
         batched Alg. 4 select op (``kernels.ops.select_neighbors``);
      4. back edges: :func:`_connect_reciprocal` re-selects each touched
         destination row once, vectorized per layer;
      5. only the adjacency of batch ∪ touched rows is copied to the
         device (``apply_adjacency_updates``).

    The device holds the fp32 rows it builds over: under a lossy codec
    the caller passes the decoded rows with ``prenormalized`` (they are
    already in their final stored form) and encodes nothing here.
    Deterministic for fixed inputs: no data-dependent host iteration
    order survives the sort-segment grouping."""
    from repro_torch.core import hnsw as thnsw   # hnsw imports this module

    if connect_impl not in ("op", "host"):
        raise ValueError(f"unknown connect_impl {connect_impl!r}")
    dev = resolve_device(device)
    v = (np.ascontiguousarray(vectors, dtype=np.float32) if prenormalized
         else _prep(vectors, metric))
    n, d = v.shape
    rng = np.random.default_rng(seed)
    mL = 1.0 / np.log(M) if M > 1 else 1.0
    levels = np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, n)) * mL).astype(np.int32),
        max_level_cap)
    # bootstrap prefix: highest-level points first so the hierarchy exists
    # (and the entry point / max_level never move after the bootstrap)
    order = np.argsort(-levels, kind="stable")
    v_ord = v[order]
    lv_ord = levels[order]

    nb = max(min(bootstrap, n), 1)     # >= 1: the beam needs an entry point
    b = SequentialBuilder(d, M=M, ef_construction=ef_construction,
                          metric=metric, capacity=n,
                          max_level_cap=max_level_cap, seed=seed)
    for i in range(nb):
        b.insert(v_ord[i], level=int(lv_ord[i]), prenormalized=prenormalized)
    if b.n >= n:
        return _permute_graph(b.graph(), order)

    lmax_cap = max(int(lv_ord.max(initial=0)), 1)
    ef_b = max(ef_construction, M + 1)

    # resident graph: ALL vectors/levels go up in the one full upload —
    # rows beyond the live prefix have no edges, so the beam cannot reach
    # them, but their payloads are gatherable by id, which is what the
    # intra-batch select needs. After this, batches ship int32 adjacency.
    b._grow(n)
    b.vectors[nb:n] = v_ord[nb:n]
    b.levels[nb:n] = lv_ord[nb:n]
    host_g = b.graph_full_capacity(lmax_cap)
    dg = thnsw.to_device_graph(host_g, device=dev)

    while b.n < n:
        lo = b.n
        hi = min(lo + batch_size, n)
        bsz = hi - lo
        batch = v_ord[lo:hi]
        k_cand = min(ef_construction, lo)      # the live prefix caps it
        # 1. one search over exactly bsz queries
        cand_ids, _ = thnsw.search_graph(dg, batch, k=k_cand, ef=ef_b,
                                         beam_impl=beam_impl)
        cand_ids = cand_ids.cpu().numpy().astype(np.int32)
        # 2. intra-batch top-K via one host self-distance block
        kb = min(bsz - 1, k_cand)
        if kb > 0:
            if metric in ("cosine", "ip"):
                blk = 1.0 - batch @ batch.T
            else:
                sq = np.einsum("bd,bd->b", batch, batch)
                blk = sq[:, None] - 2.0 * (batch @ batch.T) + sq[None, :]
            np.fill_diagonal(blk, np.inf)
            part = np.argpartition(blk, kb - 1, axis=1)[:, :kb]
            ordl = np.argsort(np.take_along_axis(blk, part, axis=1),
                              axis=1, kind="stable")
            top = np.take_along_axis(part, ordl, axis=1)
            cand_ids = np.concatenate(
                [cand_ids, (lo + top).astype(np.int32)], axis=1)
        # 3. forward edges: one (member, layer) row per live layer,
        # level-masked candidates, batched select at m=M
        lvls = lv_ord[lo:hi].astype(np.int64)
        counts = lvls + 1
        pj = np.repeat(np.arange(bsz), counts)
        plc = (np.arange(counts.sum())
               - np.repeat(np.cumsum(counts) - counts, counts))
        crows = cand_ids[pj]                                  # [R, C]
        clev = np.where(crows >= 0, b.levels[np.clip(crows, 0, n - 1)], -1)
        crows = np.where(clev >= plc[:, None], crows, -1)
        sel = _select_batched(dg.vectors, batch[pj], crows, m=M,
                              metric=metric)                  # [R, M]
        nodes = (lo + pj).astype(np.int32)
        for lc in np.unique(plc):
            rm = plc == lc
            if lc == 0:
                b.neighbors0[nodes[rm], :M] = sel[rm]   # fresh rows: -1 tail
            else:
                b.upper[lc - 1, nodes[rm]] = sel[rm]
        # 4. reciprocal connect, grouped by destination
        vm = sel.ravel() >= 0
        dirty = _connect_reciprocal(
            b, np.repeat(nodes, M)[vm], sel.ravel()[vm],
            np.repeat(plc, M)[vm].astype(np.int32),
            dev_vectors=dg.vectors, impl=connect_impl)
        b.n = hi
        # 5. adjacency-only copy of the dirty rows
        thnsw.apply_adjacency_updates(dg, host_g,
                                      set(range(lo, hi)) | set(dirty))

    return _permute_graph(b.graph(), order)


def bulk_build_legacy(vectors: np.ndarray, *, M: int = 16,
                      ef_construction: int = 200,
                      metric: str = "cosine", seed: int = 0,
                      bootstrap: int = 256, batch_size: int = 1024,
                      prenormalized: bool = False,
                      device=None) -> HNSWGraph:
    """The reference's pre-resident bulk builder, kept verbatim as the
    build benchmark's baseline (``h2d_vs_legacy``), on ``device``
    (default: the card). Every batch re-uploads the whole capacity graph
    (``to_device_graph``, counted in ``hnsw.h2d_bytes``: O(N²/batch)
    bytes), runs one ``search_graph`` over it (one ``greedy_descent`` and
    one ``beam_search`` launch on the card) and connects every edge in
    per-node, per-layer host loops. It also keeps the bootstrap-capped
    ``k_cand`` that :func:`bulk_build` fixed: this is the measured old
    behaviour, not a semantics to improve."""
    from repro_torch.core import hnsw as thnsw   # hnsw imports this module

    dev = resolve_device(device)
    v = (np.ascontiguousarray(vectors, dtype=np.float32) if prenormalized
         else _prep(vectors, metric))
    n, d = v.shape
    rng = np.random.default_rng(seed)
    mL = 1.0 / np.log(M) if M > 1 else 1.0
    levels = np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, n)) * mL).astype(np.int32), 12)
    # bootstrap prefix: highest-level points first so the hierarchy exists
    order = np.argsort(-levels, kind="stable")
    v_ord = v[order]
    lv_ord = levels[order]

    nb = min(bootstrap, n)
    b = SequentialBuilder(d, M=M, ef_construction=ef_construction,
                          metric=metric, capacity=n, seed=seed)
    for i in range(nb):
        b.insert(v_ord[i], level=int(lv_ord[i]), prenormalized=prenormalized)

    m_max0 = 2 * M
    lmax_cap = max(int(lv_ord.max(initial=0)), 1)
    k_cand = min(ef_construction, nb)
    ef_b = max(ef_construction, M + 1)
    while b.n < n:
        lo = b.n
        hi = min(lo + batch_size, n)
        batch = v_ord[lo:hi]
        if hi - lo < batch_size:            # pad the tail batch (fixed shapes)
            batch = np.concatenate(
                [batch, np.zeros((batch_size - (hi - lo), d), np.float32)])
        b._grow(n)
        g = b.graph_full_capacity(lmax_cap)
        # one batched beam search over the prefix for all batch members
        cand_ids, cand_dist = thnsw.search_graph(
            thnsw.to_device_graph(g, device=dev), batch, k=k_cand, ef=ef_b)
        cand_ids = cand_ids.cpu().numpy()
        cand_dist = cand_dist.cpu().numpy()
        for j in range(hi - lo):
            node = b.n
            lvl = int(lv_ord[node])
            b.vectors[node] = batch[j]
            b.levels[node] = lvl
            b.n += 1
            ids = cand_ids[j][cand_ids[j] >= 0]
            dist = cand_dist[j][: len(ids)]
            for lc in range(min(lvl, b.max_level), -1, -1):
                mask = b.levels[ids] >= lc
                ids_l, dist_l = ids[mask], dist[mask]
                if not len(ids_l):
                    continue
                nbrs = b._select_heuristic(batch[j],
                                           list(zip(dist_l, ids_l.tolist())),
                                           M)
                b._set_nbrs(node, lc, nbrs)
                mcap = m_max0 if lc == 0 else M
                for e in nbrs:
                    cur = b._nbrs(int(e), lc)
                    if node not in cur:
                        cur = np.append(cur, node).astype(np.int32)
                    if len(cur) > mcap:
                        ev = b.vectors[int(e)]
                        cd = list(zip(_dist(metric, ev, b.vectors[cur]),
                                      [int(c) for c in cur]))
                        cur = b._select_heuristic(ev, cd, mcap)
                    b._set_nbrs(int(e), lc, cur)
            if lvl > b.max_level:
                b.entry, b.max_level = node, lvl

    return _permute_graph(b.graph(), order)


def _permute_graph(g: HNSWGraph, order: np.ndarray) -> HNSWGraph:
    """Graph built over permuted rows -> graph in original row order."""
    n = g.n
    new_of_old = np.asarray(order[:n], np.int64)   # builder id -> original id

    def remap_ids(a):
        out = np.full_like(a, -1)
        valid = a >= 0
        out[valid] = new_of_old[a[valid]]
        return out

    return HNSWGraph(
        vectors=_scatter_rows(g.vectors, new_of_old),
        neighbors0=_scatter_rows(remap_ids(g.neighbors0), new_of_old),
        upper=np.stack([_scatter_rows(remap_ids(u), new_of_old)
                        for u in g.upper])
              if g.upper.shape[0] else g.upper,
        levels=_scatter_rows(g.levels, new_of_old),
        entry=int(new_of_old[g.entry]) if g.entry >= 0 else -1,
        max_level=g.max_level,
        metric=g.metric,
        n=n,
    )


def _scatter_rows(a: np.ndarray, new_of_old: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    out[new_of_old] = a
    return out
