"""The work one ``beam_search`` launch needs, counted by a frozen copy of
the layer-0 ef-beam traversal (the port's ``kernels/ref.py:
beam_search_ref`` as of this benchmark's first version), run in plain
PyTorch on the launch's own inputs: the graph's rows and layer-0 lists,
the queries, and the entry points the descent found. It returns the
distinct rows whose distance some query needs, the distinct lists some
query expands and the (query, row) pairs, which ``arith.beam_search_work``
turns into bytes and operations, and the beam it ends with, which the
reference's ``hnsw_search`` answers from. Nothing here imports the
program."""
from __future__ import annotations

import torch

INF = 3.0e38


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def schedule(ef: int, expand_t: int, max_iters: int | None
             ) -> tuple[int, int, int]:
    """(t, budget, hops): ``expand_t`` frontier nodes a hop against a
    total budget of ``max_iters`` expansions (default ef, plus one slack
    hop when t > 1)."""
    t = max(1, min(int(expand_t), int(ef)))
    budget = ((int(ef) + (t if t > 1 else 0)) if max_iters is None
              else int(max_iters))
    return t, budget, (-(-budget // t) if budget > 0 else 0)


def _frontier(bd, bi, bx, t_live, t):
    unexp = (~bx) & (bi >= 0)
    u = unexp.to(torch.int32)
    rank = torch.cumsum(u, dim=-1, dtype=torch.int32) - u
    sel = unexp & (rank < t_live)
    neg = torch.full_like(bi, -1)
    nodes = torch.stack([torch.where(sel & (rank == j), bi, neg).amax(dim=-1)
                         for j in range(t)], dim=-1)
    return bx | sel, nodes


def _dedup(cand, valid, bi):
    w = cand.shape[-1]
    in_beam = (cand[:, :, None] == bi[:, None, :]).any(dim=-1)
    eq = cand[:, :, None] == cand[:, None, :]
    ar = torch.arange(w, device=cand.device)
    earlier = ar[:, None] > ar[None, :]
    dup = (eq & earlier[None] & valid[:, None, :]).any(dim=-1)
    return valid & ~in_beam & ~dup


def _lexsort(d, i, x):
    o = torch.sort(i, dim=-1, stable=True).indices
    d, i, x = d.gather(-1, o), i.gather(-1, o), x.gather(-1, o)
    o = torch.sort(d, dim=-1, stable=True).indices
    return d.gather(-1, o), i.gather(-1, o), x.gather(-1, o)


def _merge(bd, bi, bx, cd, ci, ef: int):
    b, efp = bd.shape
    live = torch.arange(efp, device=bd.device) < ef
    md = torch.cat([bd, cd], dim=-1)
    mi = torch.cat([bi, ci], dim=-1)
    mx = torch.cat([bx, torch.zeros_like(cd, dtype=torch.bool)], dim=-1)
    md, mi, mx = _lexsort(md, mi, mx)
    return (torch.where(live, md[:, :efp], INF),
            torch.where(live, mi[:, :efp], -1),
            torch.where(live, mx[:, :efp], True))


def _dist(vectors, q, ids, metric, scales):
    x = vectors[ids.long()].float()
    if scales is not None:
        x = x * scales[ids.long()].float()[..., None]
    if metric in ("cosine", "ip"):
        return 1.0 - torch.einsum("bd,bkd->bk", q.float(), x)
    diff = x - q.float()[:, None, :]
    return torch.einsum("bkd,bkd->bk", diff, diff)


@torch.no_grad()
def traversal(vectors, neighbors0, q, ep, ep_dist, *, ef: int,
              metric: str = "cosine", scales=None, expand_t: int = 4,
              max_iters: int | None = None) -> dict:
    """-> {rows, lists, pairs, ids, dists}: distinct rows needed, distinct
    lists expanded, (query, row) distances, for one launch's inputs, and
    the final beam [B, ef'] ascending by (distance, id), empty slots
    (-1, INF) last."""
    b = q.shape[0]
    n, m2 = neighbors0.shape
    dev = q.device
    t, budget, hops = schedule(ef, expand_t, max_iters)
    col = torch.arange(_pow2(ef), device=dev)[None, :]
    bd = torch.where(col == 0, ep_dist[:, None].float(),
                     torch.tensor(INF, device=dev))
    bi = torch.where(col == 0, ep[:, None].to(torch.int32),
                     torch.tensor(-1, dtype=torch.int32, device=dev))
    bx = (col != 0).expand(b, col.shape[1])
    rows = torch.zeros(n, dtype=torch.bool, device=dev)
    lists = torch.zeros(n, dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    hop = 0
    while hop < hops and bool(((~bx) & (bi >= 0)).any()):
        t_live = min(t, budget - hop * t)
        bx, nodes = _frontier(bd, bi, bx, t_live, t)
        nbrs = neighbors0[nodes.clamp(0, n - 1).long()]
        valid = ((nodes >= 0)[:, :, None] & (nbrs >= 0)).reshape(b, t * m2)
        cand = nbrs.clamp(0, n - 1).reshape(b, t * m2)
        d = _dist(vectors, q, cand, metric, scales)
        valid = _dedup(cand, valid, bi)
        lists[nodes[nodes >= 0].clamp(0, n - 1).long()] = True
        rows[cand[valid].long()] = True
        pairs += valid.sum()
        bd, bi, bx = _merge(bd, bi, bx, torch.where(valid, d, INF),
                            torch.where(valid, cand, -1).to(torch.int32),
                            int(ef))
        hop += 1
    return dict(rows=int(rows.sum()), lists=int(lists.sum()),
                pairs=int(pairs), ids=bi, dists=bd)
