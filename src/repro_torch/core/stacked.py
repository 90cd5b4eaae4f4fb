"""Segment fan-out for graph-backed shards, ported from
``repro/core/stacked.py``.

A sharded HNSW is a segment set: each shard owns an independent graph
over its hash-routed keys. The reference stacks the shards' device graphs
along a leading [S, ...] axis, capacity-padded to the largest, and runs
the lock-step search of every shard in one ``shard_map`` program. The
port holds each shard's ``DeviceGraph`` on its own device, so there is
nothing to pad or stack: a search copies the query batch to each shard's
device once, queues every shard's fused search (``ops.greedy_descent``
and then ``ops.beam_search``; the per-hop route with ``beam_impl="jnp"``)
before any host read, and merges the shards' [B, k] lists on the first
shard's device through the tree (``distributed/collectives.py``).

The reference's numbering stays: a hit's global id is ``gid = s · cap +
node``, ``cap`` the largest shard's capacity, so a caller inverts it to
(shard, node) without a table; the index caches a ``StackedGraphs`` by
mutation epoch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core import hnsw as thnsw
from repro_torch.core.sharded import INF, per_device, resolve_wire_bf16
from repro_torch.distributed.collectives import hierarchical_topk

# incremented once per fan-out search (one ``search_stacked`` call,
# whatever the shard count), as the reference's module global
DISPATCH_COUNT = 0


@dataclasses.dataclass(frozen=True)
class StackedGraphs:
    """The shards' resident device graphs (None: an empty shard, which
    returns nothing), each on its shard's device, and the common ``cap``
    (the largest shard's capacity) that numbers the global ids."""
    graphs: list
    cap: int

    @property
    def devices(self) -> list:
        return [g.device for g in self.graphs if g is not None]


def stack_device_graphs(graphs: list) -> StackedGraphs:
    """The shards' resident graphs (None = empty shard) -> the segment
    set. Nothing is copied: each graph stays on its device."""
    live = [g for g in graphs if g is not None]
    if not live:
        raise ValueError("index is empty")
    return StackedGraphs(graphs=list(graphs), cap=max(g.n for g in live))


def search_stacked(st: StackedGraphs, queries, k: int, ef: int,
                   wire_bf16: bool | None = None, beam_impl: str = "fused"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Batched k-NN over a segment set: queries [B, D] -> (dists [B, k],
    gids [B, k]), missing slots (INF, -1). Each non-empty shard runs
    ``hnsw.search_core`` on its own device; only the query batch moves
    from the host."""
    global DISPATCH_COUNT
    ef = max(ef, k)
    first = next(g for g in st.graphs if g is not None)
    qs = per_device(thnsw._prep_queries(first, queries), st.devices)
    DISPATCH_COUNT += 1
    dispatch.bump("stacked.search_stacked")
    parts = []
    for s, g in enumerate(st.graphs):
        if g is None:
            continue
        dispatch.bump("stacked.beam_launches",
                      dispatch.beam_launches(beam_impl, ef))
        ids, d = thnsw.search_core(g, qs[g.device], k, ef,
                                   beam_impl=beam_impl)
        live = ids >= 0
        parts.append((torch.where(live, d, INF),
                      torch.where(live, s * st.cap + ids, -1)))
    d, gid = hierarchical_topk(parts, k,
                               wire_bf16=resolve_wire_bf16(wire_bf16),
                               tie_break_ids=True)
    return d.cpu().numpy(), gid.cpu().numpy()
