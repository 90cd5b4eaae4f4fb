"""Batch-synchronous HNSW search in PyTorch (fixed shapes, lock-step).

Every query of the batch advances together (the reference's DESIGN.md §2):

  * upper layers: greedy descent, one hop per loop iteration, all queries
    stepping together until none improves (``ops.greedy_descent``). On
    the card it is ONE launch for every layer and hop, each query
    stopping on its own (``hnsw.descent_launches``); on the CPU the plain
    version's per-hop loop;
  * layer 0: the ef-beam best-first search, either as ONE launch of the
    fused ``beam_search`` kernel (``beam_impl="fused"``, default) or as
    the per-hop reference loop (``beam_impl="jnp"``, the name kept from
    the JAX package so configurations stay interchangeable), whose hops
    launch ``gather_distance``.

The JAX package runs both loops as ``while_loop``s on the device. The
port runs the descent and the fused beam inside their kernels, with no
host read. The Python loops left, the per-hop beam and the descent's
plain version on the CPU, end each hop with one device-to-host read of
their loop condition (counted in ``hnsw.host_syncs``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.codec import device_rows
from repro_torch.core.hnsw_build import HNSWGraph
from repro_torch.kernels import ops
from repro_torch.kernels.ref import lexsort2

INF = 3.0e38

# frontier nodes expanded per hop on the fused beam path: ceil(ef / T)
# hops against the same ef-expansion budget as the reference
DEFAULT_EXPAND_T = 4


@dataclasses.dataclass
class DeviceGraph:
    """HNSW graph as dense tensors on one device.

    ``deleted`` is the tombstone mask: tombstoned rows stay traversable
    during the search (hnswlib-style) but are never returned.

    ``vectors`` holds the rows in their storage dtype: f32, or bf16/int8
    under a lossy codec, with ``scales`` carrying the int8 per-row decode
    scales. Every distance decodes to fp32 inside the kernels, so device
    memory holds the small encoding while the math stays fp32.
    """
    vectors: torch.Tensor      # [N, D] f32/bf16/int8 (normalised if cosine)
    neighbors0: torch.Tensor   # [N, 2M] int32 (-1 pad)
    upper: torch.Tensor        # [L, N, M] int32 (-1 pad); L may be 0
    levels: torch.Tensor       # [N] int32
    entry: int
    deleted: torch.Tensor      # [N] bool tombstones
    max_level: int
    metric: str
    scales: torch.Tensor | None = None   # [N] f32 decode scales (int8)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def _adjacency_bytes_per_row(g: HNSWGraph) -> int:
    return 4 * (g.neighbors0.shape[1]
                + g.upper.shape[0] * (g.upper.shape[2]
                                      if g.upper.shape[0] else 0))


def _graph_bytes_per_row(g: HNSWGraph, enc: np.ndarray | None = None,
                         scales: np.ndarray | None = None) -> int:
    """Bytes one row moves host -> device: its vector in storage dtype,
    its adjacency, its level and, with a scale table, its scale."""
    return (g.vectors.shape[1] * (4 if enc is None else enc.itemsize)
            + _adjacency_bytes_per_row(g) + 4
            + (4 if scales is not None else 0))


def _up(a: np.ndarray, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)


def to_device_graph(g: HNSWGraph, deleted: np.ndarray | None = None, *,
                    enc: np.ndarray | None = None,
                    scales: np.ndarray | None = None,
                    device) -> DeviceGraph:
    """Full host -> device upload (the from-scratch path; incremental
    updates go through :func:`apply_row_updates`).

    ``enc``/``scales``: codec-encoded rows (+ int8 scales) to upload
    INSTEAD of the host f32 vectors, in the same [N, D] capacity view."""
    n = g.vectors.shape[0]
    if deleted is None:
        deleted = np.zeros(n, bool)
    dispatch.bump("hnsw.h2d_bytes", n * _graph_bytes_per_row(g, enc, scales))
    dev = torch.device(device)

    def up(a, dtype):
        return _up(a, dtype, dev)

    return DeviceGraph(
        vectors=(up(g.vectors, torch.float32) if enc is None
                 else device_rows(enc, dev)),
        neighbors0=up(g.neighbors0, torch.int32),
        upper=up(g.upper, torch.int32),
        levels=up(g.levels, torch.int32),
        entry=max(int(g.entry), 0),
        deleted=up(deleted[:n], torch.bool),
        max_level=int(g.max_level),
        metric=g.metric,
        scales=None if scales is None else up(scales, torch.float32),
    )


def _padded_rows(rows) -> np.ndarray:
    """Sorted row ids padded to a power of two with repeats of the first
    (idempotent copies): the JAX package pads so that its scatter compiles
    once per bucket; the port pads so that ``hnsw.h2d_bytes`` counts the
    same bytes."""
    rows = np.asarray(sorted(int(r) for r in rows), np.int64)
    if not rows.size:
        return rows
    bucket = 1 << (int(rows.size) - 1).bit_length()
    return np.concatenate([rows, np.full(bucket - rows.size, rows[0])])


def _copy_adjacency(dg: DeviceGraph, g: HNSWGraph, rp: np.ndarray,
                    idx: torch.Tensor) -> None:
    dev = dg.device
    dg.neighbors0.index_copy_(0, idx, _up(g.neighbors0[rp], torch.int32, dev))
    if g.upper.shape[0]:
        dg.upper.index_copy_(1, idx, _up(g.upper[:, rp], torch.int32, dev))


def apply_row_updates(dg: DeviceGraph, g: HNSWGraph, rows,
                      deleted: np.ndarray | None = None, *,
                      enc: np.ndarray | None = None,
                      scales: np.ndarray | None = None) -> DeviceGraph:
    """Incremental device-graph sync: copy only the dirty ``rows`` of the
    host graph into the resident tensors, IN PLACE (``index_copy_``; the
    JAX package donates the buffers to a functional scatter instead).
    Shapes must match the resident graph. ``deleted`` refreshes the
    tombstone mask; entry/max_level are always refreshed.

    ``enc``/``scales``: the codec-encoded rows when the resident graph
    stores encoded rows, indexed by dirty row id (the canonical [n, D]
    arrays serve as they are: every dirty row is < n) — the encoded row
    and its scale travel instead of the f32 vector."""
    if tuple(dg.vectors.shape) != g.vectors.shape \
            or tuple(dg.upper.shape) != g.upper.shape:
        raise ValueError("capacity/layer shape changed; full rebuild required")
    rp = _padded_rows(rows)
    dev = dg.device
    if rp.size:
        dispatch.bump("hnsw.h2d_bytes",
                      rp.size * _graph_bytes_per_row(g, enc, scales))
        idx = torch.as_tensor(rp).to(dev)
        dg.vectors.index_copy_(0, idx, _up(g.vectors[rp], torch.float32, dev)
                               if enc is None else device_rows(enc[rp], dev))
        if scales is not None:
            dg.scales.index_copy_(0, idx, _up(scales[rp], torch.float32, dev))
        dg.levels.index_copy_(0, idx, _up(g.levels[rp], torch.int32, dev))
        _copy_adjacency(dg, g, rp, idx)
    if deleted is not None:
        dg.deleted.copy_(torch.as_tensor(deleted[: dg.n]).to(dev))
    dg.entry = max(int(g.entry), 0)
    dg.max_level = int(g.max_level)
    return dg


def apply_adjacency_updates(dg: DeviceGraph, g: HNSWGraph,
                            rows) -> DeviceGraph:
    """Copy only neighbors0/upper of the dirty ``rows`` (vectors, scales and
    levels untouched) IN PLACE, and refresh entry/max_level. Bulk ingest's
    reciprocal connect rewrites the neighbor lists of rows whose vectors
    are unchanged: only their int32 adjacency travels."""
    if tuple(dg.neighbors0.shape) != g.neighbors0.shape \
            or tuple(dg.upper.shape) != g.upper.shape:
        raise ValueError("capacity/layer shape changed; full rebuild required")
    rp = _padded_rows(rows)
    dev = dg.device
    if rp.size:
        dispatch.bump("hnsw.h2d_bytes",
                      rp.size * _adjacency_bytes_per_row(g))
        _copy_adjacency(dg, g, rp, torch.as_tensor(rp).to(dev))
    dg.entry = max(int(g.entry), 0)
    dg.max_level = int(g.max_level)
    return dg


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------
def batched_dist(metric: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q [B, D], x [B, K, D] -> [B, K] (f32)."""
    if metric in ("cosine", "ip"):
        return 1.0 - torch.einsum("bd,bkd->bk", q, x)
    d = x - q[:, None, :]
    return torch.einsum("bkd,bkd->bk", d, d)


def _prep_queries(g: DeviceGraph, queries) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=g.device, dtype=torch.float32)
    else:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(g.device)
    if q.dim() == 1:
        q = q[None]
    if g.metric == "cosine":
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    return q.contiguous()


def _synced_any(mask: torch.Tensor) -> bool:
    """Read a loop condition back to the host (one counted sync)."""
    dispatch.bump("hnsw.host_syncs")
    return bool(mask.any().item())


# ---------------------------------------------------------------------------
# layer-0 beam search
# ---------------------------------------------------------------------------
def _beam_search(g: DeviceGraph, q: torch.Tensor, ep: torch.Tensor,
                 ep_dist: torch.Tensor, ef: int, max_iters: int | None = None):
    """Per-hop ef-beam best-first search on layer 0 (expands the best
    unexpanded entry of every query per hop). Returns sorted (ids, dists)."""
    b = q.shape[0]
    m2 = g.neighbors0.shape[1]
    dev = q.device
    # explicit None check: max_iters=0 means ZERO expansions
    max_iters = ef if max_iters is None else max_iters
    rows = torch.arange(b, device=dev)
    beam_d = torch.full((b, ef), INF, device=dev)
    beam_d[:, 0] = ep_dist
    beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_i[:, 0] = ep
    beam_x = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters and _synced_any((~beam_x) & (beam_i >= 0)):
        cand_d = torch.where(beam_x | (beam_i < 0), INF, beam_d)
        j = torch.argmin(cand_d, dim=-1)                     # [B]
        has = cand_d[rows, j] < INF
        cur = beam_i[rows, j]
        beam_x = beam_x.clone()
        beam_x[rows, j] = beam_x[rows, j] | has
        nbrs = g.neighbors0[cur.clamp(0, g.n - 1).long()]
        valid = (nbrs >= 0) & has[:, None]
        ids = nbrs.clamp(0, g.n - 1).contiguous()
        d = ops.gather_distance(g.vectors, q, ids, metric=g.metric,
                                scales=g.scales)
        d = torch.where(valid, d, INF)
        # merge into the beam: two-key sort, then adjacent-dup masking
        all_d = torch.cat([beam_d, d], dim=1)                # [B, ef+2M]
        all_i = torch.cat([beam_i, ids], dim=1)
        all_x = torch.cat([beam_x, torch.zeros((b, m2), dtype=torch.bool,
                                               device=dev)], dim=1)
        all_i = torch.where(all_d >= INF, -1, all_i)
        sd, si, sx = lexsort2(all_d, all_i, all_x)
        dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                         (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)], dim=1)
        sd = torch.where(dup, INF, sd)
        sx = torch.where(dup, True, sx)
        sd, si, sx = lexsort2(sd, si, sx)
        beam_d, beam_i, beam_x = sd[:, :ef], si[:, :ef], sx[:, :ef]
        it += 1
    return beam_i, beam_d


def _beam_search_fused(g: DeviceGraph, q: torch.Tensor, ep: torch.Tensor,
                       ep_dist: torch.Tensor, ef: int,
                       max_iters: int | None = None,
                       expand_t: int | None = None):
    """One-launch layer-0 beam search through ``ops.beam_search``,
    expanding the top-T frontier nodes per hop."""
    return ops.beam_search(
        g.vectors, g.neighbors0, q, ep.to(torch.int32).contiguous(),
        ep_dist.float().contiguous(), ef=ef, metric=g.metric,
        scales=g.scales,
        expand_t=DEFAULT_EXPAND_T if expand_t is None else expand_t,
        max_iters=max_iters)


def search_core(g: DeviceGraph, q: torch.Tensor, k: int, ef: int,
                max_iters: int | None = None, beam_impl: str = "fused",
                beam_expand: int | None = None):
    """Whole-search body: descent + beam + tombstone filter. Queries must
    already be prepped (``_prep_queries``).

    ``beam_impl``: "fused" (default) runs the layer-0 beam as one kernel
    launch; "jnp" is the per-hop reference loop. ``beam_expand``
    overrides the fused path's per-hop expansion width."""
    if beam_impl not in ("fused", "jnp"):
        raise ValueError(f"unknown beam_impl {beam_impl!r}; "
                         "expected 'fused' or 'jnp'")
    b = q.shape[0]
    ep = torch.full((b,), g.entry, dtype=torch.int32, device=q.device)
    x0 = g.vectors[ep.long()].float()
    if g.scales is not None:                 # decode the entry row
        x0 = x0 * g.scales[ep.long()][:, None]
    ep_dist = batched_dist(g.metric, q, x0[:, None])[:, 0]
    if g.max_level > 0:
        ep, ep_dist = ops.greedy_descent(
            g.vectors, g.upper, q, ep, ep_dist.contiguous(),
            max_level=g.max_level, metric=g.metric, scales=g.scales)
    if beam_impl == "fused":
        beam_i, beam_d = _beam_search_fused(g, q, ep, ep_dist, ef,
                                            max_iters, beam_expand)
    else:
        beam_i, beam_d = _beam_search(g, q, ep, ep_dist, ef, max_iters)
    # tombstone filter: deleted rows were traversable but are never returned
    dead = g.deleted[beam_i.clamp(0, g.n - 1).long()] | (beam_i < 0)
    beam_d = torch.where(dead, INF, beam_d)
    beam_i = torch.where(dead, -1, beam_i)
    order = torch.sort(beam_d, dim=1, stable=True).indices
    beam_d, beam_i = beam_d.gather(1, order), beam_i.gather(1, order)
    return beam_i[:, :k], beam_d[:, :k]


def search_graph(g: DeviceGraph, queries, k: int = 10, ef: int = 64,
                 max_iters: int | None = None, beam_impl: str = "fused",
                 beam_expand: int | None = None):
    """Batched k-NN query. queries [B, D] (or [D]) -> (ids [B,k] int32,
    dist [B,k] f32) as tensors on the graph's device."""
    q = _prep_queries(g, queries)
    ef = max(ef, k)
    dispatch.bump("hnsw.search_graph")
    dispatch.bump("hnsw.beam_launches",
                  dispatch.beam_launches(beam_impl, ef, max_iters))
    return search_core(g, q, k, ef, max_iters, beam_impl, beam_expand)


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean fraction of true k-NN recovered (set semantics per row)."""
    f = np.asarray(found_ids)
    t = np.asarray(true_ids)
    if t.size == 0:
        return 0.0
    member = (t[:, :, None] == f[:, None, :]).any(axis=2)      # [B, K]
    k = t.shape[1]
    dup = ((t[:, :, None] == t[:, None, :])
           & (np.arange(k)[None, :, None] > np.arange(k)[None, None, :]))
    member &= ~dup.any(axis=2)
    return float(member.sum()) / max(t.size, 1)
