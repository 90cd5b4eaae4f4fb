"""Top-k merge of per-shard candidates and the int8 compressed
all-reduce (``compressed_psum``), ported from
``repro/distributed/collectives.py``.

The reference runs these inside ``shard_map``: every shard holds its own
(dists, ids) [B, k] and the rounds exchange them with ``lax.ppermute`` or
``lax.all_gather``. The port runs one process that holds one tensor a
shard, each on its shard's device, so a call takes the list of the
shards' (dists, ids) and an exchange is a peer copy
(``Tensor.to(device, non_blocking=True)``; a no-op between shards that
share a device).

Two strategies, as in the reference:

* the all-gather oracle (``topk_merge_axis(..., tree=False)``): every
  shard's candidates side by side [B, S·k], one sort. The parity
  reference: under ``tie_break_ids`` the tree equals it bit for bit;
* the tree (the default): with p = 2^⌊log2 S⌋ and rem = S − p, the tail
  shards p + j fold into shards j < rem, a butterfly over the p shards
  (partner = rank XOR stride) runs log2 p rounds, and shards j < rem
  send the result back to the tail, so every shard ends with it. Each
  round keeps the k best of 2k per pair.

``tie_break_ids`` orders by (distance, id): a stable ``torch.sort`` by id
and then a stable one by distance, never ``torch.topk``, whose order of
ties is unspecified on the card. Without it, ties keep the order in which
the candidates stand (``lax.top_k`` puts the lower index first).
"""
from __future__ import annotations

import torch


def _smallest_k(d: torch.Tensor, i: torch.Tensor, k: int, tie_break_ids: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best columns of (d, i) [B, W], ascending by (d, i) under
    ``tie_break_ids``, else by d with ties in column order."""
    if tie_break_ids:
        o = torch.sort(i, dim=-1, stable=True).indices
        d, i = torch.gather(d, -1, o), torch.gather(i, -1, o)
    o = torch.sort(d, dim=-1, stable=True).indices[:, :k]
    return torch.gather(d, -1, o), torch.gather(i, -1, o)


def _merge_pair(a: tuple[torch.Tensor, torch.Tensor],
                b: tuple[torch.Tensor, torch.Tensor], k: int,
                tie_break_ids: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of two candidate sets [B, k] each, on ``a``'s device."""
    dev = a[0].device
    d = torch.cat([a[0], b[0].to(dev, non_blocking=True)], dim=1)
    i = torch.cat([a[1], b[1].to(dev, non_blocking=True)], dim=1)
    return _smallest_k(d, i, k, tie_break_ids)


def _on(part: tuple[torch.Tensor, torch.Tensor], dev: torch.device):
    return (part[0].to(dev, non_blocking=True),
            part[1].to(dev, non_blocking=True))


def tree_merge(parts: list[tuple[torch.Tensor, torch.Tensor]], k: int, *,
               tie_break_ids: bool = False
               ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The reference's recursive-doubling rounds over the shards' (dists,
    ids) [B, k] -> every shard's merged (dists, ids), each on its own
    shard's device (replicated). A pair's merge runs once, on the lower
    rank's device, and its result is copied to the partner: the merge is
    symmetric, so both ends of a pair hold the same k best."""
    s = len(parts)
    if s <= 1:
        return list(parts)
    devs = [p[0].device for p in parts]
    p = 1 << (s.bit_length() - 1)
    rem = s - p
    cur = list(parts)
    for j in range(rem):                      # fold tail shard p + j into j
        cur[j] = _merge_pair(cur[j], cur[p + j], k, tie_break_ids)
    for r in range(p.bit_length() - 1):       # log2(p) butterfly rounds
        stride = 1 << r
        nxt = list(cur)
        for a in range(p):
            b = a ^ stride
            if a < b:
                nxt[a] = _merge_pair(cur[a], cur[b], k, tie_break_ids)
                nxt[b] = _on(nxt[a], devs[b])
        cur = nxt
    for j in range(rem):                      # back to the tail shards
        cur[p + j] = _on(cur[j], devs[p + j])
    return cur


def topk_merge_axis(parts: list[tuple[torch.Tensor, torch.Tensor]], k: int,
                    *, tie_break_ids: bool = False, tree: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge the shards' (dists, ids) [B, k] -> (dists, ids) [B, k] on the
    first shard's device: the tree (``tree=True``, the reference's
    ``axis_size=S``), or the all-gather oracle (``tree=False``, its
    ``axis_size=None``)."""
    if tree:
        return tree_merge(parts, k, tie_break_ids=tie_break_ids)[0]
    dev = parts[0][0].device
    d = torch.cat([p[0].to(dev, non_blocking=True) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev, non_blocking=True) for p in parts], dim=1)
    return _smallest_k(d, i, k, tie_break_ids)


def hierarchical_topk(parts: list[tuple[torch.Tensor, torch.Tensor]],
                      k: int, *, wire_bf16: bool = False,
                      tie_break_ids: bool = False, tree: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge the shards' local top-k (one mesh axis: the retrieval
    callers' ``(SHARD_AXIS,)``). ``wire_bf16`` converts the distances to
    bf16 once before the first round and back after it, as the reference
    does: half the bytes a round, ordering to bf16 resolution, ids
    exact."""
    out_dtype = parts[0][0].dtype
    if wire_bf16:
        parts = [(d.to(torch.bfloat16), i) for d, i in parts]
    d, i = topk_merge_axis(parts, k, tie_break_ids=tie_break_ids, tree=tree)
    return d.to(out_dtype), i


def compressed_psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reference's int8 chunk-quantized all-reduce over the shards'
    tensors (one a shard, each on its own device) -> every shard's sum,
    on its own device: a reduce-scatter and an all-gather with int8
    payloads, 4x fewer wire bytes than an fp32 ring all-reduce; the
    per-chunk scales travel as fp32 scalars.

    Step by step as the reference: each shard pads its flat tensor to a
    multiple of S and splits it into S chunks, scales each by
    ``max|chunk| / 127 + 1e-20`` and rounds half to even into int8 (clip
    to ±127); chunk s of every shard goes to shard s, which dequantizes
    and sums them; that sum is quantized again, every shard gathers the
    S int8 chunks, dequantizes and unpads. The sum runs in shard order
    and divisions are by tensors, so the card rounds as the CPU does."""
    s = len(parts)
    shape, dtype = parts[0].shape, parts[0].dtype
    devs = [p.device for p in parts]
    n = parts[0].numel()
    pad = (-n) % s

    def quantize(x):
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        scale = amax / amax.new_tensor(127.0) + 1e-20
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale

    q, scale = zip(*(quantize(torch.nn.functional.pad(
        x.reshape(-1), (0, pad)).reshape(s, -1)) for x in parts))
    # reduce-scatter: chunk r of every shard to shard r, dequantize + sum
    pq, psc = [], []
    for r, dev in enumerate(devs):
        part = None                     # [n/S] f32, summed in shard order
        for qi, si in zip(q, scale):
            term = qi[r].to(dev, non_blocking=True).to(torch.float32) \
                * si[r].to(dev, non_blocking=True)
            part = term if part is None else part + term
        a, b = quantize(part)
        pq.append(a)
        psc.append(b)
    # all-gather the reduced chunks, int8-quantized again
    out = []
    for dev in devs:
        all_q = torch.stack([a.to(dev, non_blocking=True) for a in pq])
        all_sc = torch.stack([b.to(dev, non_blocking=True) for b in psc])
        y = (all_q.to(torch.float32) * all_sc).reshape(-1)[:n]
        out.append(y.reshape(shape).to(dtype))
    return out
