"""Plain PyTorch versions of every hand kernel (the correctness contract).

Each function here is the port of its jnp oracle in ``repro/kernels/ref.py``
and computes the same function the same way: the CPU tests hold these
against the JAX package's oracles, and ``chip_smoke.py`` holds every CUDA
kernel against these on the card. ``kernels.ops`` runs them for tensors
that lie on the CPU.
"""
from __future__ import annotations

import torch

# == core.hnsw.INF (empty-slot distance)
BEAM_INF = 3.0e38

METRICS = ("cosine", "ip", "l2")


def gather_distance_ref(vectors: torch.Tensor, q: torch.Tensor,
                        ids: torch.Tensor, *, metric: str = "cosine",
                        scales: torch.Tensor | None = None) -> torch.Tensor:
    """vectors [N,D] (f32, bf16 or int8 rows), q [B,D], ids [B,K] (valid,
    clamped) -> dists [B,K]: ``1 - <q, x>`` for cosine/ip, squared L2
    otherwise, in fp32. ``scales`` [N] decodes each gathered row as
    ``row · scale`` in fp32 before the distance."""
    idl = ids.long()
    x = vectors[idl].float()                             # [B,K,D]
    if scales is not None:
        x = x * scales[idl].float()[..., None]
    qf = q.float()
    if metric in ("cosine", "ip"):
        return 1.0 - torch.einsum("bd,bkd->bk", qf, x)
    d = x - qf[:, None, :]
    return torch.einsum("bkd,bkd->bk", d, d)


def greedy_descent_ref(vectors: torch.Tensor, upper: torch.Tensor,
                       q: torch.Tensor, ep: torch.Tensor,
                       ep_dist: torch.Tensor, *, max_level: int,
                       metric: str = "cosine",
                       scales: torch.Tensor | None = None, gather=None,
                       stats: dict | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the upper-layer greedy descent, the lock-step loop
    of ``core/hnsw.py`` (the JAX package's ``_greedy_layer``) for layers
    ``max_level`` .. 1: per hop every query reads ``upper[layer - 1][ep]``
    [B, M], clamps the ids to [0, N), scores them (slots with id < 0 at
    INF), takes the argmin (lowest slot among ties) and moves iff it beats
    ``ep_dist``; a layer ends when no query moved. vectors [N, D] (any
    codec dtype; ``scales`` [N] decodes), upper [L, N, M] i32, q [B, D],
    ep [B] i32, ep_dist [B] f32 -> (ep, ep_dist).

    ``gather`` scores a hop's ids (default ``gather_distance_ref``;
    ``kernels.ops.gather_distance`` runs the loop through the hop
    kernel). ``stats``, a dict, receives ``syncs`` (loop-condition reads,
    one a hop plus one a layer), ``lockstep_hops``, ``hops`` ([B] i32,
    the hops each query needs when it stops as soon as it does not
    improve: its moves plus one a layer), and the work those hops read:
    ``lists`` (distinct (layer, node) lists), ``rows`` (bool [N], rows of
    valid slots) and ``pairs`` ((query, valid slot) distances)."""
    gather = gather_distance_ref if gather is None else gather
    n = vectors.shape[0]
    b = q.shape[0]
    dev = q.device
    ep = ep.to(torch.int32)
    ep_dist = ep_dist.float()
    syncs = lockstep = pairs = lists = 0
    if stats is not None:
        hops = torch.zeros(b, dtype=torch.int32, device=dev)
        rows = torch.zeros(n, dtype=torch.bool, device=dev)
    for layer in range(int(max_level), 0, -1):
        table = upper[layer - 1]
        improved = torch.ones(b, dtype=torch.bool, device=dev)
        if stats is not None:
            seen = torch.zeros(n, dtype=torch.bool, device=dev)
        while True:
            syncs += 1
            if not bool(improved.any()):
                break
            lockstep += 1
            nbrs = table[ep.long()]                            # [B, M]
            valid = nbrs >= 0
            ids = nbrs.clamp(0, n - 1).contiguous()
            if stats is not None:        # the queries still moving
                hops += improved.to(torch.int32)
                seen[ep[improved].long()] = True
                live = valid & improved[:, None]
                rows[ids[live].long()] = True
                pairs += int(live.sum())
            d = gather(vectors, q, ids, metric=metric, scales=scales)
            d = torch.where(valid, d, BEAM_INF)
            j = torch.argmin(d, dim=-1, keepdim=True)
            best_d = torch.gather(d, 1, j)[:, 0]
            best_i = torch.gather(ids, 1, j)[:, 0]
            improved = best_d < ep_dist
            ep = torch.where(improved, best_i, ep)
            ep_dist = torch.where(improved, best_d, ep_dist)
        if stats is not None:
            lists += int(seen.sum())
    if stats is not None:
        stats.update(syncs=syncs, lockstep_hops=lockstep, hops=hops,
                     lists=lists, rows=rows, pairs=pairs)
    return ep, ep_dist


# ---------------------------------------------------------------------------
# exact search
# ---------------------------------------------------------------------------
def smallest_k(d: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of d [B, W] with their ids,
    ordered by (d, id) — provided equal distances already stand in
    ascending id order along the row, which a stable sort then keeps
    (``lax.top_k`` puts the lower index first among ties; ``torch.topk``
    leaves the tie order unspecified)."""
    o = torch.sort(d, dim=-1, stable=True).indices[:, :k]
    return torch.gather(d, -1, o), torch.gather(ids, -1, o)


def distance_topk_ref(db: torch.Tensor, q: torch.Tensor, k: int, *,
                      metric: str = "cosine",
                      scales: torch.Tensor | None = None,
                      after: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """db [N,D] (f32, bf16 or int8 rows; ``scales`` [N] decodes each row
    by a multiply), q [B,D] f32 -> (dists [B,k] ascending, ids [B,k]
    i32), ordered by (d, id). cosine/ip score ``1 - <q, x>``; l2 the
    expanded ``|q|^2 - 2 <q, x> + |x|^2``, as the TPU kernel computes it.

    ``after`` = (d [B] f32, id [B] i32) keeps only the rows that come
    strictly after that pair in (d, id) order, per query: one pass of
    ``kernels.ops.topk_in_passes``, which needs k <= the rows kept."""
    x = db.float()
    if scales is not None:
        x = x * scales.float()[:, None]
    qf = q.float()
    s = qf @ x.T
    if metric in ("cosine", "ip"):
        d = 1.0 - s
    else:
        d = ((qf * qf).sum(-1)[:, None] - 2.0 * s) + (x * x).sum(-1)[None, :]
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=d.device)
    if after is not None:
        ad, ai = after[0][:, None], after[1][:, None]
        keep = (d > ad) | ((d == ad) & (ids[None, :] > ai))
        d = torch.where(keep, d, torch.inf)
    return smallest_k(d, ids.expand(d.shape[0], -1), k)


# ---------------------------------------------------------------------------
# fused beam search: shared algorithm + plain version
# ---------------------------------------------------------------------------
def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def beam_select_frontier(bd, bi, bx, t_live, t: int):
    """Mark the first ``t_live`` (<= t) unexpanded entries of the
    (ascending-sorted) beam as expanded and extract their node ids.
    Returns (new_bx, nodes [B, t] with -1 for unfilled slots). An entry's
    rank among unexpanded entries is the exclusive prefix count."""
    unexp = (~bx) & (bi >= 0)
    u = unexp.to(torch.int32)
    rank = torch.cumsum(u, dim=-1, dtype=torch.int32) - u
    sel = unexp & (rank < t_live)
    neg = torch.full_like(bi, -1)
    nodes = torch.stack(
        [torch.where(sel & (rank == j), bi, neg).amax(dim=-1)
         for j in range(t)], dim=-1)
    return bx | sel, nodes


def beam_dedup_valid(cand, valid, bi):
    """Drop candidates already in the beam, or duplicated EARLIER in the
    flat candidate list (keep the first valid copy)."""
    w = cand.shape[-1]
    in_beam = (cand[:, :, None] == bi[:, None, :]).any(dim=-1)
    eq = cand[:, :, None] == cand[:, None, :]
    ar = torch.arange(w, device=cand.device)
    earlier = ar[:, None] > ar[None, :]
    dup = (eq & earlier[None] & valid[:, None, :]).any(dim=-1)
    return valid & ~in_beam & ~dup


def lexsort2(d, i, x):
    """Sort (d, i, x) along the last axis by the two-key (d, i) order:
    a stable sort by the minor key, then a stable sort by the major."""
    o = torch.sort(i, dim=-1, stable=True).indices
    d, i, x = (torch.gather(d, -1, o), torch.gather(i, -1, o),
               torch.gather(x, -1, o))
    o = torch.sort(d, dim=-1, stable=True).indices
    return (torch.gather(d, -1, o), torch.gather(i, -1, o),
            torch.gather(x, -1, o))


def beam_merge(bd, bi, bx, cd, ci, ef: int):
    """One-hop beam merge: the ef smallest (d, id) entries of the beam
    and the candidates (a stable two-key sort of their concatenation);
    entries past ``ef`` reset to (INF, -1, expanded). The JAX oracle's
    bitonic network gives the same beam: live (d, id) keys are unique
    after dedup, and ties exist only among (INF, -1) pads, whose expanded
    bit is never read."""
    b, efp = bd.shape
    w = cd.shape[-1]
    dev = bd.device
    live = torch.arange(efp, device=dev) < ef
    md = torch.cat([bd, cd], dim=-1)
    mi = torch.cat([bi, ci], dim=-1)
    mx = torch.cat([bx, torch.zeros((b, w), dtype=torch.bool, device=dev)],
                   dim=-1)
    md, mi, mx = lexsort2(md, mi, mx)
    return (torch.where(live, md[:, :efp], BEAM_INF),
            torch.where(live, mi[:, :efp], -1),
            torch.where(live, mx[:, :efp], True))


def beam_schedule(ef: int, expand_t: int,
                  max_iters: int | None) -> tuple[int, int, int]:
    """-> (t, budget, hops) of the fused layer-0 beam.

    ``expand_t`` frontier nodes expand per hop against a TOTAL budget of
    ``max_iters`` expansions (default ef, plus one slack hop when t > 1),
    so hops = ceil(budget / t) with the last hop truncated — exactly
    ``repro/kernels/beam_search.py:_call``."""
    t = max(1, min(int(expand_t), int(ef)))
    budget = ((int(ef) + (t if t > 1 else 0)) if max_iters is None
              else int(max_iters))
    hops = -(-budget // t) if budget > 0 else 0
    return t, budget, hops


def beam_search_ref(vectors: torch.Tensor, neighbors0: torch.Tensor,
                    q: torch.Tensor, ep: torch.Tensor, ep_dist: torch.Tensor,
                    *, ef: int, metric: str = "cosine",
                    scales: torch.Tensor | None = None, expand_t: int = 4,
                    max_iters: int | None = None,
                    return_visited: bool = False):
    """Plain version of the fused layer-0 ef-beam search: frontier
    selection, dedup and merge per hop, with the row gather done by
    ``gather_distance_ref``. vectors [N, D] (any codec dtype; ``scales``
    [N] decodes), neighbors0 [N, 2M] i32 (-1 pad), q [B, D] f32,
    ep/ep_dist [B] -> (ids [B, ef] i32, dists [B, ef] f32) ascending by
    (d, id); empty slots (-1, INF). At expand_t=1 the visit order is the
    one-at-a-time ``core.hnsw._beam_search`` order.

    ``return_visited`` adds a third result, the work the search needs:
    ``rows`` (bool [N], rows whose distance some query needed — valid
    candidates after dedup), ``lists`` (bool [N], nodes some query
    expanded) and ``pairs`` (the (query, row) distances computed)."""
    b = q.shape[0]
    n, m2 = neighbors0.shape
    dev = q.device
    t, budget, hops = beam_schedule(ef, expand_t, max_iters)
    efp = next_pow2(ef)
    col = torch.arange(efp, device=dev)[None, :]
    bd = torch.where(col == 0, ep_dist[:, None].float(),
                     torch.tensor(BEAM_INF, device=dev))
    bi = torch.where(col == 0, ep[:, None].to(torch.int32),
                     torch.tensor(-1, dtype=torch.int32, device=dev))
    bx = (col != 0).expand(b, efp)
    rows = torch.zeros(n, dtype=torch.bool, device=dev)
    lists = torch.zeros(n, dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    hop = 0
    while hop < hops and bool(((~bx) & (bi >= 0)).any()):
        t_live = min(t, budget - hop * t)
        bx, nodes = beam_select_frontier(bd, bi, bx, t_live, t)
        nbrs = neighbors0[nodes.clamp(0, n - 1).long()]         # [B, t, 2M]
        valid = ((nodes >= 0)[:, :, None] & (nbrs >= 0)).reshape(b, t * m2)
        cand = nbrs.clamp(0, n - 1).reshape(b, t * m2)
        d = gather_distance_ref(vectors, q, cand, metric=metric,
                                scales=scales)
        valid = beam_dedup_valid(cand, valid, bi)
        cd = torch.where(valid, d, BEAM_INF)
        ci = torch.where(valid, cand, -1).to(torch.int32)
        if return_visited:
            lists[nodes[nodes >= 0].clamp(0, n - 1).long()] = True
            rows[cand[valid].long()] = True
            pairs += valid.sum()
        bd, bi, bx = beam_merge(bd, bi, bx, cd, ci, int(ef))
        hop += 1
    if return_visited:
        return bi[:, :ef], bd[:, :ef], dict(rows=rows, lists=lists,
                                            pairs=int(pairs))
    return bi[:, :ef], bd[:, :ef]


# ---------------------------------------------------------------------------
# batched neighbor-selection heuristic (HNSW construction)
# ---------------------------------------------------------------------------
INT32_MAX = 2 ** 31 - 1


def select_neighbors_ref(vectors: torch.Tensor, q: torch.Tensor,
                         cand_ids: torch.Tensor, *, m: int,
                         metric: str = "cosine",
                         scales: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Malkov & Yashunin Alg. 4 (``keepPrunedConnections=True``),
    per row output-identical to the host oracle
    ``core.hnsw_build.select_heuristic_host``.

    vectors [N, D] (any codec dtype; ``scales`` [N] decodes), q [B, D]
    f32, cand_ids [B, C] i32 with -1 padding -> (ids [B, m] i32 -1-pad,
    dists [B, m] f32 INF-pad, in selection order).

    Per row: duplicate ids keep their first occurrence; candidates sort
    by the two-key (dist-to-q, id) order; a masked keep-scan walks them
    in that order, keeping candidate ``i`` iff no already-kept ``j`` has
    ``pd[i, j] < d[i]``; the first ``m`` keeps are the picks, and
    pruned candidates backfill in sorted order. ``pd`` is one [B, C, C]
    einsum, which runs in full fp32 (TF32 stays off, PyTorch's default).
    The scan is a C-step Python loop of tensor ops: no host sync."""
    b, c = cand_ids.shape
    dev = q.device
    cand_ids = cand_ids.to(torch.int32)
    if c < m:                      # width must cover the output slots
        cand_ids = torch.cat([cand_ids, torch.full(
            (b, m - c), -1, dtype=torch.int32, device=dev)], dim=1)
        c = m
    n = vectors.shape[0]
    valid = cand_ids >= 0
    idc = cand_ids.clamp(0, n - 1)
    # keep-first dedup (the mask construction of beam_dedup_valid)
    eq = idc[:, :, None] == idc[:, None, :]
    ar = torch.arange(c, device=dev)
    earlier = ar[:, None] > ar[None, :]
    valid = valid & ~(eq & earlier[None] & valid[:, None, :]).any(dim=-1)
    d = gather_distance_ref(vectors, q, idc, metric=metric, scales=scales)
    d = torch.where(valid, d, BEAM_INF)
    sid = torch.where(valid, cand_ids, INT32_MAX)
    sd, si, _ = lexsort2(d, sid, sid)                  # (d, id) ascending
    svalid = sd < BEAM_INF
    # pairwise distances between the sorted candidates, decoded in fp32
    sil = si.clamp(0, n - 1).long()
    x = vectors[sil].float()
    if scales is not None:
        x = x * scales[sil].float()[..., None]
    dots = torch.einsum("bid,bjd->bij", x, x)
    if metric in ("cosine", "ip"):
        pd = 1.0 - dots
    else:
        sq = (x * x).sum(dim=-1)
        pd = (sq[:, :, None] - 2.0 * dots) + sq[:, None, :]
    # rej[:, i, j]: a kept j would reject candidate i (the host oracle's
    # strict test pd[i, j] < d(i, q))
    rej = pd < sd[:, :, None]
    kept = torch.zeros((b, c), dtype=torch.bool, device=dev)
    for i in range(c):
        kept[:, i] = svalid[:, i] & ~(kept & rej[:, i, :]).any(dim=-1)
    ki = kept.to(torch.int32)
    primary = kept & ((torch.cumsum(ki, dim=-1) - ki) < m)
    # heuristic picks first (in sorted order), then the backfill in sorted
    # order; invalid slots sorted to the very end by construction
    pos = ar.expand(b, c)
    order = torch.argsort(torch.where(primary, pos, pos + c), dim=-1)[:, :m]
    out_i = torch.gather(si, 1, order)
    out_d = torch.gather(sd, 1, order)
    out_v = torch.gather(svalid, 1, order)
    return (torch.where(out_v, out_i, -1).to(torch.int32),
            torch.where(out_v, out_d, BEAM_INF))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
NEG = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cur_len) -> torch.Tensor:
    """q [B,H,Dh]; k,v [B,S,KVH,Dh]; mask pos >= cur_len -> out [B,H,Dh]
    f32. ``cur_len`` is a scalar or [B]. Query head h reads KV head
    h // (H / KVH), as ``q.reshape(b, kvh, g, dh)`` groups them."""
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float() * dh ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    cur = torch.as_tensor(cur_len, dtype=torch.int32,
                          device=q.device).reshape(-1).expand(b)
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < cur[:, None, None, None])
    scores = torch.where(mask, scores, NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, dh)


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------
def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None, *,
                      combine: str = "sum") -> torch.Tensor:
    """table [R,E] (f32 or bf16), ids [B,L] in [0, R), weights [B,L] f32
    or None -> bags [B,E] f32: the gathered rows [B,L,E] in fp32, times
    their weights, summed over L; ``mean`` divides by L without weights
    and by ``max(sum w, 1e-9)`` with them. ``index_select`` raises on an
    id outside [0, R) (the JAX oracle's ``jnp.take`` fills instead)."""
    b, l = ids.shape
    g = table.index_select(0, ids.reshape(-1).long()).reshape(
        b, l, table.shape[1]).float()
    if weights is not None:
        g = g * weights.float()[..., None]
    s = g.sum(dim=1)
    if combine == "mean":
        n = (l if weights is None else torch.clamp_min(
            weights.float().sum(-1, keepdim=True), 1e-9))
        s = s / n
    return s
