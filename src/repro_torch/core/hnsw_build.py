"""HNSW construction, host half.

``SequentialBuilder`` is a faithful Malkov & Yashunin (Alg. 1-4, incl. the
neighbor-selection heuristic) in numpy — the mutable host graph behind
``core/interface.py:HNSW`` and the recall reference. It is a copy of the
reference's numpy builder (``repro/core/hnsw_build.py``), so a graph built
from the same rows and seed is bit-identical in both packages.

The device-resident ``bulk_build`` waits for its own slice (ROADMAP.md §1,
"bulk_build with select_neighbors").
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


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
    with keepPrunedConnections backfill) — the loop the reference's
    vectorized ``select_neighbors`` is pinned against, and the port's will
    be when ``bulk_build`` is ported. Identical to
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

