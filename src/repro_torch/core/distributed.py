"""Distributed retrieval over a STATIC row array, ported from
``repro/core/distributed.py``: the rows split in S contiguous blocks, one
a shard device, a per-shard top-k and the tree merge.

The mutable counterpart is ``core/sharded.py:ShardedRows`` (keyed CRUD,
key -> shard routing, free-slot bookkeeping) on the same fan-out and
merge; this module stays the thin entry point over a fixed array.
"""
from __future__ import annotations

import torch

from repro_torch.core.sharded import trim_merge_width
from repro_torch.distributed.collectives import hierarchical_topk
from repro_torch.kernels import ops


def sharded_flat_topk(devices: list, db: torch.Tensor, queries: torch.Tensor,
                      k: int, *, metric: str = "cosine",
                      wire_bf16: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """db [N, D] (f32 or bf16 rows; shard s holds rows [s·R, (s+1)·R) on
    ``devices[s]``, R = ceil(N / S)), queries [B, D] f32, prepared by the
    caller -> (dists [B, k], global row ids [B, k]) on the first device.

    N need not be a multiple of S: the last block is padded with zero rows
    whose ids (>= N) are masked to (inf, -1) before the merge; each shard
    over-fetches ``k + pad`` rows, so padding never displaces a real row.
    The merge orders by distance alone (no id tie-break), as the
    reference's. ``wire_bf16``: the distances turn bf16 at the source and
    stay bf16."""
    s = len(devices)
    n = db.shape[0]
    rows_per = -(-n // s)                 # ceil: nothing dropped
    pad = rows_per * s - n
    if pad:
        db = torch.cat([db, torch.zeros((pad, db.shape[1]), dtype=db.dtype,
                                        device=db.device)])
    q = queries.to(torch.float32).contiguous()
    parts = []
    for j, dev in enumerate(devices):
        blk = db[j * rows_per:(j + 1) * rows_per].to(dev).contiguous()
        d, i = ops.flat_topk(blk, q.to(dev), min(rows_per, k + pad),
                             metric=metric)
        if wire_bf16:
            d = d.to(torch.bfloat16)
        i = i + j * rows_per
        sentinel = i >= n
        d = torch.where(sentinel, torch.inf, d)
        i = torch.where(sentinel, -1, i)
        parts.append(trim_merge_width(d, i, k, torch.inf))
    return hierarchical_topk(parts, k, wire_bf16=wire_bf16)


def make_retrieval_step(devices: list, k: int, metric: str = "cosine"):
    """A retrieval step over ``devices``: (db, q) -> (dists, ids)."""

    def retrieval_step(db, q):
        return sharded_flat_topk(devices, db, q, k, metric=metric)

    return retrieval_step
