"""Uniform fanout neighbour sampler over a CSR graph, ported from
``repro/models/sampler.py``.

CSR layout: ``row_ptr [N+1]``, ``col_idx [E]``. For each seed ``fanout``
neighbours are drawn uniformly **with replacement** (GraphSAGE's
estimator is unbiased under it, and the shapes stay fixed); zero-degree
nodes fall back to self-loops. The uniforms come from a
``torch.Generator``; ``neighbors_from_uniform`` is the step from a draw to
ids, the same as the reference's for the same draw.
"""
from __future__ import annotations

import numpy as np
import torch


def draw_uniform(generator: torch.Generator, shape: tuple[int, int]
                 ) -> torch.Tensor:
    """U[0, 1) fp32 draws of ``shape`` from ``generator``, on its device."""
    return torch.rand(shape, generator=generator, device=generator.device)


def neighbors_from_uniform(u: torch.Tensor, row_ptr: torch.Tensor,
                           col_idx: torch.Tensor,
                           seeds: torch.Tensor) -> torch.Tensor:
    """u [B, fanout] fp32 in [0, 1), seeds [B] -> neighbour ids [B, fanout]
    int32: offset floor(u * max(deg, 1)) into each seed's CSR row."""
    seeds = seeds.long()
    start = row_ptr[seeds].long()
    deg = row_ptr[seeds + 1].long() - start                        # [B]
    offs = torch.floor(u * torch.clamp_min(deg, 1)[:, None].float()).long()
    idx = torch.clamp(start[:, None] + offs, 0, col_idx.shape[0] - 1)
    nbrs = col_idx[idx]                                            # [B, fanout]
    return torch.where(deg[:, None] > 0, nbrs,
                       seeds[:, None].to(nbrs.dtype)).to(torch.int32)


def sample_neighbors(generator: torch.Generator, row_ptr: torch.Tensor,
                     col_idx: torch.Tensor, seeds: torch.Tensor,
                     fanout: int) -> torch.Tensor:
    """seeds [B] -> sampled neighbour ids [B, fanout] int32, the uniforms
    drawn from ``generator`` (on the graph's device)."""
    u = draw_uniform(generator, (seeds.shape[0], fanout))
    return neighbors_from_uniform(u, row_ptr, col_idx, seeds)


def make_csr(n_nodes: int, edge_src, edge_dst):
    """Host-side CSR construction from an edge list (numpy)."""
    order = np.argsort(edge_src, kind="stable")
    src = np.asarray(edge_src)[order]
    dst = np.asarray(edge_dst)[order]
    counts = np.bincount(src, minlength=n_nodes)
    row_ptr = np.zeros(n_nodes + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, dst.astype(np.int32)
