"""The plain reference the benchmark holds the program's answers against,
in PyTorch alone and in float32 with TF32 off. It imports nothing of the
program. It reads the benchmark's own inputs (rows and queries the
benchmark drew) and the program's outputs only to judge them, with one
exception, named here: ``hnsw_search`` walks the graph the program's
set-up built (its neighbour lists, levels and entry point), since an HNSW
answer is defined by its graph. ``graph_faults`` checks that graph by
itself.

* ``exact_topk`` / ``row_distances``: cosine search over the rows,
  ``1 - <q, x>`` on unit rows, as MeMemo defines its distance.
* ``hnsw_search``: the HNSW search over a built graph, as the port
  defines it: the greedy descent of the upper layers from the entry point
  (each query moves to the nearest row of its node's list, the lowest
  slot among equal distances, while that is strictly nearer), then the
  layer-0 ef-beam of ``beam_work.traversal`` (``EXPAND_T`` frontier nodes
  a hop, a budget of ef + ``EXPAND_T`` expansions), its k nearest.
* ``graph_faults``: the invariants of an HNSW graph, counted.

``precision="tf32"`` selects the control of ``exact_topk``: both operands
of the products rounded to TF32 (``tf32``) and summed in fp32, as a TF32
tensor-core product does.
"""
from __future__ import annotations

import contextlib

import torch

from chipbench.lib import beam_work

EXPAND_T = 4
INF = beam_work.INF


@contextlib.contextmanager
def fp32_products():
    """Matrix products in full fp32 (TF32 off) inside; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), held in fp32:
    what a TF32 product reads of an fp32 operand, on any device."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def exact_topk(rows_unit: torch.Tensor, q: torch.Tensor, k: int, *,
               block: int = 512, precision: str = "fp32"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k of q [B, D] over unit rows [N, D] -> (ids [B,k]
    int64, distances [B,k]), ``block`` queries at a time."""
    qn = unit_rows(q)
    if precision == "tf32":
        qn, rows_unit = tf32(qn), tf32(rows_unit)
    ids, dists = [], []
    with fp32_products():
        for s in range(0, qn.shape[0], block):
            sim = qn[s:s + block] @ rows_unit.T
            top = torch.topk(sim, k, dim=1)
            ids.append(top.indices)
            dists.append(1.0 - top.values)
    return torch.cat(ids), torch.cat(dists)


@torch.no_grad()
def row_distances(rows_unit: torch.Tensor, q: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """``1 - <q, x_id>`` for ids [B, k] (int64, >= 0), in fp32."""
    qn = unit_rows(q)
    x = rows_unit[ids]
    return 1.0 - (x * qn[:, None, :]).sum(-1)


@torch.no_grad()
def greedy_descent(x: torch.Tensor, upper: torch.Tensor, q: torch.Tensor,
                   ep: torch.Tensor, ep_dist: torch.Tensor,
                   max_level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Layers ``max_level`` .. 1 of the descent over unit rows x [N, D] and
    upper [L, N, M] (-1 pad), for unit queries q [B, D] from ep [B]."""
    n = x.shape[0]
    for layer in range(int(max_level), 0, -1):
        table = upper[layer - 1]
        while True:
            nbrs = table[ep.long()]                             # [B, M]
            d = 1.0 - torch.einsum("bd,bmd->bm", q,
                                   x[nbrs.clamp(0, n - 1).long()])
            d = torch.where(nbrs >= 0, d, INF)
            best = d.argmin(dim=1, keepdim=True)        # the lowest slot
            bd = d.gather(1, best)[:, 0]
            move = bd < ep_dist
            if not bool(move.any()):
                break
            ep = torch.where(move, nbrs.gather(1, best)[:, 0], ep)
            ep_dist = torch.where(move, bd, ep_dist)
    return ep, ep_dist


@torch.no_grad()
def hnsw_search(x: torch.Tensor, graph: dict, q: torch.Tensor, k: int,
                ef: int) -> torch.Tensor:
    """The k nearest [B, k] (ids of the graph, int64, -1 where the beam
    holds fewer) of queries q [B, D] over unit rows x [N, D] in the
    graph's order; ``graph``: ``neighbors0`` [N, 2M], ``upper`` [L, N, M],
    ``entry``, ``max_level`` (``graph_faults``'s layout)."""
    qn = unit_rows(q)
    b = qn.shape[0]
    with fp32_products():
        ep = torch.full((b,), graph["entry"], dtype=torch.int32,
                        device=qn.device)
        ep_dist = 1.0 - qn @ x[graph["entry"]]
        ep, ep_dist = greedy_descent(x, graph["upper"], qn, ep, ep_dist,
                                     graph["max_level"])
        w = beam_work.traversal(x, graph["neighbors0"], qn, ep, ep_dist,
                                ef=max(ef, k), expand_t=EXPAND_T)
    return w["ids"][:, :k].long()


@torch.no_grad()
def graph_faults(graph: dict) -> int:
    """Broken invariants of a built graph over its n rows, counted: an
    entry point off the graph or below the top level; a link out of range,
    to itself, repeated within a list, from a node above its level or to a
    node below the link's layer; a tombstone (the cells delete nothing)."""
    nb0, up, lv = graph["neighbors0"], graph["upper"], graph["levels"]
    n = lv.shape[0]
    e = graph["entry"]
    bad = int(not (0 <= e < n) or int(lv[e]) != graph["max_level"])
    bad += int(graph["max_level"] > up.shape[0])
    bad += int(graph["deleted"].sum())
    rows = torch.arange(n, device=lv.device)[:, None]
    for layer, table in enumerate([nb0] + list(up), start=0):
        valid = table >= 0
        bad += int((table >= n).sum() + (table < -1).sum())
        t = table.clamp(-1, n - 1).long()
        bad += int((valid & (t == rows)).sum())
        s = torch.sort(torch.where(valid, t, -1 - torch.arange(
            t.shape[1], device=t.device)), dim=1).values
        bad += int((s[:, 1:] == s[:, :-1]).sum())
        if layer:
            bad += int((valid & (lv[:, None] < layer)).sum())
            bad += int((valid & (lv[t.clamp_min(0)] < layer)).sum())
    return bad
