"""Multi-tenant index pool: many small private indexes, one device arena,
ported from ``repro/core/tenancy.py``.

MeMemo's deployment shape is many *per-user* corpora, not one big index:
a user's few-hundred-row private knowledge base is the unit of isolation,
admission and deletion. ``IndexPool`` multiplexes tenants over ONE shared
``ShardedRows`` arena:

  * **namespacing**: a tenant's rows live in the arena under
    ``tenant_id + NS_SEP + key``; the same blake2b key -> shard routing
    spreads every tenant over the shards.
  * **slab allocation**: ``SlabRows`` hands out each shard's slot space in
    fixed ``slab_rows``-sized slabs, each owned by one tenant at a time.
    Resident tenants pack into one shared [n_slabs · R, D] block a shard,
    while a tenant's search gathers only its own slabs (``index_select``)
    and runs ``ops.flat_topk`` over them: the ``distance_topk`` kernel on
    the card, its plain version on the CPU. A search costs the tenant's
    rows, not the arena's.
  * **per-tenant epochs**: the pool keeps a ``mutation_epoch`` a tenant
    with exactly the bump schedule of a dedicated ``FlatVectorIndex``, so
    one user's delete invalidates only their cache entries
    (``serve/retrieval.py`` keys its LRU on the tenant and checks epochs
    per tenant).
  * **LRU residency**: at most ``max_resident`` tenants hold arena
    capacity; the rest live in per-tenant ``IndexStore`` directories
    (``root/tenants/<quoted id>``). Evict = snapshot + remove the tenant's
    rows from the arena + drop the packed blocks; admit = the store's
    bit-for-bit warm restore adopted back into the arena.
  * **byte absence, per tenant**: ``compact(tid)`` removes the tenant's
    tombstoned rows from the host arrays, from the shared device blocks
    (packed again without them) and from the tenant's store (snapshot,
    WAL truncation, old snapshots purged).

Before compaction a tombstoned row's bytes remain in the tenant's host
arrays and WAL, as in a single index; they are never packed into a
device block again, never returned, and never visible to another tenant:
a freed slab handed to tenant B is zero-filled at pack time (free slots
carry gid -1 and zero rows), so slab reuse cannot expose the previous
owner's vectors.

The reference runs the S shards as one ``shard_map`` program and pads
every shard's block to the largest shard's slab count. The port holds
one tensor a shard on ``devices[s]`` at that shard's own slab count
(an empty shard: one zero slab), queues every shard's scan before the
merge (``hierarchical_topk(tie_break_ids=True)``, as ``fanout_topk``
does), and returns the same keys. The reference's cross-tenant search is
plain jnp; here it is plain torch (a per-query slab gather, a masked
einsum with TF32 off and a stable sort).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import urllib.parse

import numpy as np
import torch

from repro_torch.core.codec import VectorCodec, effective_rerank, get_codec
from repro_torch.core.flat import FlatVectorIndex, _pad_results
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.core.sharded import (INF, ShardedRows, _quantize_slack,
                                      normalized, per_device, place_blocks,
                                      shard_of_key, trim_merge_width)
from repro_torch.distributed.collectives import hierarchical_topk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k
from repro_torch.utils import resolve_device

# Unit separator: cannot appear in tenant ids or doc keys (validated at
# the pool boundary), so the namespaced key is unambiguous.
NS_SEP = "\x1f"


def tenant_key(tid: str, key: str) -> str:
    """Namespaced arena key for one tenant's document."""
    return tid + NS_SEP + key


def split_tenant_key(nskey: str) -> tuple[str, str]:
    """Inverse of :func:`tenant_key` -> (tenant_id, doc key)."""
    tid, _, key = nskey.partition(NS_SEP)
    return tid, key


# ---------------------------------------------------------------------------
# tenant-scoped search (slab gather + fused top-k + tree merge)
# ---------------------------------------------------------------------------
def _slab_gather(blocks: torch.Tensor, gids: torch.Tensor,
                 scl: torch.Tensor | None, tbl: torch.Tensor, slab_rows: int):
    """Gather one tenant's slabs out of a shard's packed block.

    blocks [RT, D] (RT = n_slabs · slab_rows), gids [RT], tbl [L] slab ids
    (-1 padding) -> (db [L·R, D], gid [L·R], scales [L·R] | None).
    Padding entries clip to slab 0, which may hold ANOTHER tenant's live
    rows, so their gathered gids are forced to -1 here; nothing downstream
    may trust a gid at a padded position."""
    nsl = max(blocks.shape[0] // slab_rows, 1)
    idx = torch.clamp(tbl, 0, nsl - 1).long()
    db = blocks.view(nsl, slab_rows, -1).index_select(0, idx).reshape(
        -1, blocks.shape[-1])
    g = gids.view(nsl, slab_rows).index_select(0, idx).reshape(-1)
    g = torch.where(torch.repeat_interleave(tbl >= 0, slab_rows), g, -1)
    s = None
    if scl is not None:
        s = scl.view(nsl, slab_rows).index_select(0, idx).reshape(-1)
    return db, g, s


def _slab_local_topk(blocks, gids, scl, tbl, q, *, k: int, slack: int,
                     metric: str, slab_rows: int):
    """One shard's tenant-scoped top-k: gather the tenant's slabs, run the
    SAME ``ops.flat_topk`` the single index uses over the [L·R, D]
    gathered rows, over-fetch ``k + slack`` (slack bounds the invalid
    rows: free slots inside the tenant's slabs and whole padding slabs;
    the kernel cannot skip them), mask by gid, and trim to the k-wide
    merge format. ``q`` is prepared (normalized for cosine)."""
    db, g, s = _slab_gather(blocks, gids, scl, tbl, slab_rows)
    kk = min(k + slack, db.shape[0])
    d, i = ops.flat_topk(db, q, kk, metric=metric, scales=s)
    gg = g[i.long()]
    d = torch.where(gg >= 0, d, INF)
    d, gg = trim_merge_width(d, gg, k)
    return d, torch.where(d >= INF, -1, gg)


def _slab_topk_sharded(arena, tbls: list, q: torch.Tensor, *, k: int,
                       slack: int, metric: str, slab_rows: int):
    """A tenant's search: each shard gathers and scans its own slabs on
    its own device, every launch queued before the merge; at S > 1 the
    tree merge breaks ties on the smaller gid, as the single index's
    fan-out does (one shard's list passes through unmerged)."""
    devices, blocks, gids, scl = arena
    qs = per_device(q, devices)
    parts = [_slab_local_topk(blocks[s], gids[s],
                              None if scl is None else scl[s], tbls[s],
                              qs[dev], k=k, slack=slack, metric=metric,
                              slab_rows=slab_rows)
             for s, dev in enumerate(devices)]
    return hierarchical_topk(parts, k, tie_break_ids=True)


def _slab_topk_multi(arena, tables: list, q: torch.Tensor, *, k: int,
                     metric: str, slab_rows: int):
    """The cross-tenant search on every shard (``tables[s]`` [B, L], one
    slab table a query row), merged as ``_slab_topk_sharded`` merges."""
    devices, blocks, gids, scl = arena
    qs = per_device(q, devices)
    parts = [_multi_local_topk(blocks[s], gids[s],
                               None if scl is None else scl[s], tables[s],
                               qs[dev], k=k, metric=metric,
                               slab_rows=slab_rows)
             for s, dev in enumerate(devices)]
    return hierarchical_topk(parts, k, tie_break_ids=True)


def _multi_local_topk(blocks, gids, scl, tbl, q, *, k: int, metric: str,
                      slab_rows: int):
    """Cross-tenant search: every query row carries its OWN slab table.
    tbl [B, L], q [B, D] raw -> (d [B, k], gids [B, k]).

    A per-query gather ([B, L, R, D]), a masked einsum and a stable sort:
    unlike the single-tenant path the mask applies BEFORE selection, so no
    slack over-fetch is needed. Rows decode here (bf16 upcast, int8 ·
    scale): the asymmetric scan of ``flat_topk``'s fused decode. Plain
    torch on every device, as the reference keeps it in jnp; the einsum
    needs full fp32 (TF32 off, PyTorch's default), or keys would differ
    from the CPU's."""
    if torch.backends.cuda.matmul.allow_tf32 and q.device.type == "cuda":
        raise RuntimeError("the cross-tenant search needs full-fp32 "
                           "matmuls: torch.backends.cuda.matmul.allow_tf32 "
                           "is set")
    nsl = max(blocks.shape[0] // slab_rows, 1)
    d_ = blocks.shape[-1]
    idx = torch.clamp(tbl, 0, nsl - 1).long()                    # [B, L]
    rows = blocks.view(nsl, slab_rows, d_)[idx]                  # [B,L,R,D]
    g = gids.view(nsl, slab_rows)[idx]                           # [B, L, R]
    valid = (tbl >= 0)[:, :, None] & (g >= 0)
    x = rows.float()
    if scl is not None:
        x = x * scl.view(nsl, slab_rows)[idx][..., None]
    if metric == "cosine":
        q = normalized(q)
    s = torch.einsum("blrd,bd->blr", x, q)
    if metric == "l2":
        d = (torch.sum(q * q, dim=-1)[:, None, None] - 2.0 * s
             + torch.sum(x * x, dim=-1))
    else:
        d = 1.0 - s
    b = tbl.shape[0]
    d = torch.where(valid, d, INF).reshape(b, -1)
    g = g.reshape(b, -1)
    dd, gg = smallest_k(d, g, min(k, d.shape[1]))
    dd, gg = trim_merge_width(dd, gg, k)
    return dd, torch.where(dd >= INF, -1, gg)


# ---------------------------------------------------------------------------
# slab-granular arena
# ---------------------------------------------------------------------------
class SlabRows(ShardedRows):
    """``ShardedRows`` whose per-shard slot space is carved into fixed
    ``slab_rows``-sized slabs, each owned by one tenant at a time.

    The canonical layer (host vectors, keys, alive) is untouched: rows
    append in arena order, so per-tenant extraction keeps each tenant's
    own insertion order (what store parity needs). Only placement changes:
    a row's slot comes from a slab owned by its tenant (``_owner_of_row``
    parses the namespace prefix), a tombstoned slot returns to its slab,
    and a slab whose slots are all free is released to the arena for the
    next tenant that needs capacity. ``pack_arena`` zero-fills free slots,
    so a reused slab never carries its previous owner's bytes to the
    device."""

    def __init__(self, *, slab_rows: int = 64, n_shards: int = 1,
                 metric: str = "cosine", dim: int | None = None,
                 codec: VectorCodec | str | None = None, device=None):
        if slab_rows < 1:
            raise ValueError(f"slab_rows must be >= 1, got {slab_rows}")
        self.slab_rows = int(slab_rows)
        # per shard: slab -> owner tenant (None = free), slab -> free-slot
        # stack, owner -> slab ids (insertion order = allocation order)
        self._slab_owner: list[list[str | None]] = \
            [[] for _ in range(n_shards)]
        self._slab_free: list[list[list[int]]] = \
            [[] for _ in range(n_shards)]
        self._owner_slabs: list[dict[str, list[int]]] = \
            [{} for _ in range(n_shards)]
        # derived-state versioning: bumped on every _invalidate, so the
        # packed arena and the per-tenant slab tables go stale together
        self.pack_epoch = 0
        self._arena = None
        self._tables: dict[str, tuple] = {}
        self._dev_tables: dict[str, list] = {}
        super().__init__(n_shards=n_shards, metric=metric, dim=dim,
                         normalize_on_pack=True, codec=codec, device=device)

    # --------------------------------------------------------- slab layout
    def _owner_of_row(self, row: int) -> str:
        return self._keys[row].partition(NS_SEP)[0]

    def _alloc_slab(self, shard: int, owner: str) -> int:
        """Hand ``owner`` a slab on ``shard``: reuse a released slab if
        one exists (its slots are already free and zero-packed), else grow
        the shard's slot space by one slab."""
        owners = self._slab_owner[shard]
        r = self.slab_rows
        j = next((i for i, o in enumerate(owners) if o is None), None)
        if j is None:
            j = len(owners)
            owners.append(owner)
            self._slab_free[shard].append([])
            base = j * r
            self._slots[shard].extend([-1] * r)
            self._free[shard].extend(range(base, base + r))
        else:
            owners[j] = owner
        # canonical allocation order inside the slab (the same whatever
        # order the previous owner released it in)
        self._slab_free[shard][j] = list(range((j + 1) * r - 1,
                                               j * r - 1, -1))
        self._owner_slabs[shard].setdefault(owner, []).append(j)
        return j

    def _free_slab(self, shard: int, j: int) -> None:
        owner = self._slab_owner[shard][j]
        self._slab_owner[shard][j] = None
        slabs = self._owner_slabs[shard].get(owner)
        if slabs is not None:
            slabs.remove(j)
            if not slabs:
                del self._owner_slabs[shard][owner]

    def _take_slot(self, shard: int, j: int, row: int) -> int:
        slot = self._slab_free[shard][j].pop()
        self._slots[shard][slot] = row
        self._free[shard].remove(slot)
        return slot

    def _claim_slot(self, shard: int, row: int) -> int:
        owner = self._owner_of_row(row)
        for j in self._owner_slabs[shard].get(owner, ()):
            if self._slab_free[shard][j]:
                return self._take_slot(shard, j, row)
        return self._take_slot(shard, self._alloc_slab(shard, owner), row)

    def _release_row(self, row: int) -> None:
        shard, slot = int(self._row_shard[row]), int(self._row_slot[row])
        super()._release_row(row)
        j = slot // self.slab_rows
        self._slab_free[shard][j].append(slot)
        if len(self._slab_free[shard][j]) == self.slab_rows:
            self._free_slab(shard, j)      # wholly empty -> reusable

    def _reset_layout(self, vecs, keys, alive, enc=None, scales=None) -> None:
        self._slab_owner = [[] for _ in range(self.n_shards)]
        self._slab_free = [[] for _ in range(self.n_shards)]
        self._owner_slabs = [{} for _ in range(self.n_shards)]
        super()._reset_layout(vecs, keys, alive, enc=enc, scales=scales)

    def _maybe_relayout(self) -> None:
        # slab padding is free capacity by design, not dead weight: the
        # base free-fraction repack would thrash the slab assignment.
        # Dead slots are reclaimed per tenant by compact() and evict().
        pass

    def _invalidate(self) -> None:
        super()._invalidate()
        self._arena = None
        self._tables.clear()
        self._dev_tables.clear()
        self.pack_epoch += 1

    # ---------------------------------------------------- tenant extraction
    def owner_mask(self, tid: str) -> np.ndarray:
        """Bool [T] mask of arena rows (live AND tombstoned) owned by
        ``tid``."""
        pre = tid + NS_SEP
        n = len(self._keys)
        return np.fromiter((k.startswith(pre) for k in self._keys),
                           bool, count=n) if n else np.zeros(0, bool)

    def tenant_rows(self, tid: str):
        """One tenant's canonical state, in its own insertion order, with
        raw (un-namespaced) keys -> (keys, vecs, alive, enc, scales).
        Tombstoned rows included: exactly the state a dedicated single
        index would persist."""
        idx = np.flatnonzero(self.owner_mask(tid))
        keys = [self._keys[i].partition(NS_SEP)[2] for i in idx]
        d = self.dim or 0
        vecs = (np.ascontiguousarray(self._vecs[idx]) if idx.size
                else np.zeros((0, d), np.float32))
        alive = self._alive[idx].copy() if idx.size else np.zeros(0, bool)
        enc = scales = None
        if self._enc is not None:
            enc = (np.ascontiguousarray(self._enc[idx]) if idx.size
                   else np.zeros((0, d), self.codec.enc_dtype))
        if self._scales is not None:
            scales = (np.ascontiguousarray(self._scales[idx]) if idx.size
                      else np.zeros(0, np.float32))
        return keys, vecs, alive, enc, scales

    def adopt_rows(self, keys: list[str], vecs: np.ndarray,
                   alive: np.ndarray, enc: np.ndarray | None = None,
                   scales: np.ndarray | None = None) -> None:
        """Append restored tenant rows (namespaced keys) keeping their
        canonical encodings: the arena's half of a warm restore. Rows
        arrive in the tenant's stored order; dead rows keep their
        tombstone and own no slot (as in ``_reset_layout``)."""
        vecs = np.asarray(vecs, np.float32)
        alive = np.asarray(alive, bool)
        n = len(keys)
        if n and vecs.shape[1]:
            self._ensure_dim(int(vecs.shape[1]))
        self._vecs = np.concatenate([self._vecs, vecs])
        if self._enc is not None:
            if enc is None:
                raise ValueError(
                    f"{self.codec.name} arena needs encoded rows to adopt")
            self._enc = np.concatenate(
                [self._enc, np.asarray(enc, self.codec.enc_dtype)])
        if self._scales is not None:
            self._scales = np.concatenate(
                [self._scales, np.asarray(scales, np.float32)])
        base = len(self._keys)
        self._keys.extend(keys)
        self._alive = np.concatenate([self._alive, alive])
        shards = np.full(n, -1, np.int32)
        slots = np.full(n, -1, np.int32)
        for j, key in enumerate(keys):
            if not alive[j]:
                continue
            row = base + j
            self._key2row[key] = row
            s = shard_of_key(key, self.n_shards)
            shards[j] = s
            slots[j] = self._claim_slot(s, row)
        self._row_shard = np.concatenate([self._row_shard, shards])
        self._row_slot = np.concatenate([self._row_slot, slots])
        self._invalidate()

    def remove_rows(self, keep: np.ndarray) -> None:
        """Physically drop every row where ``keep`` is False: the canonical
        arrays are copied over the kept rows (fresh buffers: the dropped
        rows' bytes survive in NO host array) and slab placement is
        derived again. Eviction and per-tenant compaction land here."""
        keep = np.asarray(keep, bool)
        vecs = np.ascontiguousarray(self._vecs[keep])
        keys = [k for k, m in zip(self._keys, keep) if m]
        alive = self._alive[keep].copy()
        enc = (np.ascontiguousarray(self._enc[keep])
               if self._enc is not None else None)
        scales = (np.ascontiguousarray(self._scales[keep])
                  if self._scales is not None else None)
        self._reset_layout(vecs, keys, alive, enc=enc, scales=scales)

    # ------------------------------------------------------------- device
    def pack_arena(self):
        """(Re)build the SHARED device blocks over every resident tenant's
        live rows -> (devices, blocks, gids, scales): shard s holds its
        own [n_slabs_s · R, D] block of the codec's rows and its [n_slabs_s
        · R] gid map (and int8 scales) on ``devices[s]``, packed once a
        mutation epoch. Free slots, every slot of a released slab
        included, are zero rows with gid -1: that is what makes slab reuse
        safe. A shard that owns no slab holds one zero slab."""
        if self._arena is not None:
            return self._arena
        r = self.slab_rows
        d = self.dim or 1
        lossy = self.codec.lossy
        rows_src = self._enc if lossy else self._vecs
        blocks, gids = [], []
        scl = [] if self._scales is not None else None
        for s in range(self.n_shards):
            nsl = max(len(self._slab_owner[s]), 1)
            table = np.asarray(self._slots[s], np.int64)
            occ = np.flatnonzero(table >= 0)
            blk = np.zeros((nsl * r, d), rows_src.dtype)
            gid = np.full(nsl * r, -1, np.int32)
            blk[occ] = rows_src[table[occ]]
            gid[occ] = table[occ]
            if not lossy and self.metric == "cosine":
                blk = normalize_rows(blk)        # free slots stay zero
            blocks.append(blk)
            gids.append(gid)
            if scl is not None:
                sc = np.zeros(nsl * r, np.float32)
                sc[occ] = self._scales[table[occ]]
                scl.append(sc)
        bl, gi, sc = place_blocks(blocks, gids, self.devices, scl)
        self._arena = (list(self.devices), bl, gi, sc)
        return self._arena

    def arena_device_bytes(self) -> int:
        """Device bytes of the packed shared arena (blocks, gids, scales):
        the whole pool's footprint, NOT a tenant's."""
        _, bl, gi, sc = self.pack_arena()
        return sum(t.numel() * t.element_size()
                   for t in [*bl, *gi, *(sc or [])])

    # ------------------------------------------------------------- search
    def tenant_table(self, tid: str):
        """-> (tbl [S, L] int32 slab ids (-1 pad), L, quantized slack,
        live rows). L is the tenant's largest per-shard slab count rounded
        up to a power of two, so tenants of similar size share a shape;
        slack bounds the invalid rows a shard (free slots and padding
        slabs). Cached a ``pack_epoch``."""
        ent = self._tables.get(tid)
        if ent is not None and ent[0] == self.pack_epoch:
            return ent[1:]
        s_n, r = self.n_shards, self.slab_rows
        per = [self._owner_slabs[s].get(tid, []) for s in range(s_n)]
        mx = max(len(p) for p in per)
        l_pad = 1 if mx <= 1 else 1 << (mx - 1).bit_length()
        tbl = np.full((s_n, l_pad), -1, np.int32)
        live = 0
        slack = 0
        for s in range(s_n):
            shard_live = 0
            for c, j in enumerate(per[s]):
                tbl[s, c] = j
                shard_live += r - len(self._slab_free[s][j])
            live += shard_live
            slack = max(slack, l_pad * r - shard_live)
        out = (tbl, l_pad, _quantize_slack(slack), live)
        self._tables[tid] = (self.pack_epoch,) + out
        return out

    def tenant_live(self, tid: str) -> int:
        return self.tenant_table(tid)[3]

    def _device_tables(self, tid: str) -> list[torch.Tensor]:
        """The tenant's slab table row of each shard on that shard's
        device, uploaded once a ``pack_epoch``."""
        dev = self._dev_tables.get(tid)
        if dev is None:
            tbl = self.tenant_table(tid)[0]
            dev = self._dev_tables[tid] = [
                torch.from_numpy(tbl[s].copy()).to(d)
                for s, d in enumerate(self.devices)]
        return dev

    def tenant_topk(self, tid: str, queries: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over ONE tenant's live rows -> (dists [B, k], arena
        gids [B, k], (INF, -1)-padded). A shard's scan is one
        ``ops.flat_topk`` over the tenant's slabs, gathered on the device,
        so the cost scales with the tenant, not the arena."""
        _, _, slack, live = self.tenant_table(tid)
        if live == 0:
            raise ValueError("index is empty")
        arena = self.pack_arena()
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.devices[0])
        if self.metric == "cosine":
            q = normalized(q)
        d, g = _slab_topk_sharded(arena, self._device_tables(tid),
                                  q.contiguous(), k=k, slack=slack,
                                  metric=self.metric,
                                  slab_rows=self.slab_rows)
        return d.cpu().numpy(), g.cpu().numpy()

    def multi_topk(self, tables: np.ndarray, queries: np.ndarray, k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Cross-tenant top-k: ``tables`` [S, B, L] carries one slab table
        a query row (rows of DIFFERENT tenants batch together when their
        padded L matches)."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.devices[0])
        tbs = [torch.from_numpy(np.ascontiguousarray(tables[s])).to(dev)
               for s, dev in enumerate(self.devices)]
        d, g = _slab_topk_multi(self.pack_arena(), tbs, q, k=k,
                                metric=self.metric, slab_rows=self.slab_rows)
        return d.cpu().numpy(), g.cpu().numpy()


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _TenantState:
    epoch: int = 0
    resident: bool = False
    store: object | None = None        # IndexStore | None
    spill: tuple | None = None         # (arrays, meta) when root is None
    since_snapshot: int = 0


class IndexPool:
    """Tenant-aware multiplexer over one shared :class:`SlabRows` arena.

    Its public surface mirrors ``VectorIndex`` with a leading
    ``tenant_id`` (mutators validate and raise as a dedicated index does,
    and ``epoch(tid)`` follows the same bump schedule), plus the pool's
    own verbs: ``evict``/``admit`` (LRU paging against per-tenant
    ``IndexStore`` directories), ``compact(tid)`` (per-tenant secure
    delete) and ``query_batch_multi`` (one search across tenants).

    ``root=None`` keeps evicted tenants in host memory; with a root,
    evicted state lives ONLY on disk. ``device`` (default cuda) holds the
    arena; at ``n_shards > 1`` the shards go on
    ``core/sharded.py:shard_devices``."""

    def __init__(self, root: str | None = None, *, dim: int | None = None,
                 metric: str = "cosine", n_shards: int = 1,
                 dtype: str = "fp32", rerank_factor: int | None = None,
                 max_resident: int = 64, slab_rows: int = 64,
                 snapshot_every: int | None = None, device=None):
        if metric not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.root = str(root) if root is not None else None
        self.metric = metric
        self.dim = dim
        self.n_shards = int(n_shards)
        self.dtype = str(dtype)
        self.rerank_factor = rerank_factor
        self.max_resident = int(max_resident)
        self.slab_rows = int(slab_rows)
        self.snapshot_every = snapshot_every
        self.device = resolve_device(device)
        self._codec = get_codec(self.dtype)
        self._arena = SlabRows(slab_rows=self.slab_rows,
                               n_shards=self.n_shards, metric=metric,
                               dim=dim, codec=self._codec,
                               device=self.device)
        self._tenants: dict[str, _TenantState] = {}
        self._resident: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._epoch = 0                       # pool-global (engine compat)
        self.stats = {"admissions": 0, "evictions": 0, "snapshots": 0}

    # ----------------------------------------------------------- identity
    @property
    def mutation_epoch(self) -> int:
        """Pool-global mutation counter (the sum of all tenants'
        mutations): the coarse signal for consumers that are not
        tenant-aware. Tenant-aware caches use :meth:`epoch`."""
        return self._epoch

    @property
    def shard_count(self) -> int:
        return self.n_shards

    @property
    def storage_dtype(self) -> str:
        return self.dtype

    def epoch(self, tid: str) -> int:
        """Per-tenant mutation epoch: the bump schedule of a dedicated
        index (+1 a insert/update/delete, +1 a bulk batch, +1 a compact),
        durable across evict and restore. KeyError for a tenant the pool
        has never seen."""
        t = self._tenants.get(tid)
        if t is None:
            raise KeyError(tid)
        return t.epoch

    def tenants(self) -> list[str]:
        return list(self._tenants)

    def resident_tenants(self) -> list[str]:
        return list(self._resident)

    # ---------------------------------------------------------- residency
    def _validate_id(self, s: str, what: str) -> None:
        if not isinstance(s, str) or not s or NS_SEP in s:
            raise ValueError(f"invalid {what}: {s!r} (non-empty string "
                             "without the namespace separator)")

    def _tenant_dir(self, tid: str) -> str:
        return os.path.join(self.root, "tenants",
                            urllib.parse.quote(tid, safe=""))

    def _touch(self, tid: str) -> None:
        self._resident[tid] = None
        self._resident.move_to_end(tid)

    def _empty_adapter(self) -> FlatVectorIndex:
        return FlatVectorIndex(metric=self.metric,
                               dim=self.dim or self._arena.dim, n_shards=1,
                               dtype=self.dtype,
                               rerank_factor=self.rerank_factor,
                               device=self.device)

    def _adapter(self, tid: str, t: _TenantState) -> FlatVectorIndex:
        """The tenant's state as a real ``FlatVectorIndex``: what the store
        snapshots and attaches. Bit for bit the index a never-pooled tenant
        would have: the same canonical arrays (the tenant's insertion
        order, tombstones included), the same epoch, the same config."""
        fv = self._empty_adapter()
        keys, vecs, alive, enc, scales = self._arena.tenant_rows(tid)
        if keys:
            if self._codec.lossy:
                arrays = {"vectors_enc": self._codec.to_storage(enc),
                          "alive": alive}
                if scales is not None:
                    arrays["scales"] = scales
            else:
                arrays = {"vectors": vecs, "alive": alive}
            fv.restore_state(arrays, {"keys": keys, "epoch": t.epoch})
        else:
            fv._epoch = t.epoch
        return fv

    def _ensure_resident(self, tid: str, create: bool = False
                         ) -> _TenantState:
        self._validate_id(tid, "tenant id")
        t = self._tenants.get(tid)
        if t is None:
            store = None
            if self.root is not None:
                from repro_torch.store import IndexStore
                store = IndexStore(self._tenant_dir(tid),
                                   page_bytes=4 << 20)
                if store.has_state():
                    t = _TenantState(store=store)
                    self._tenants[tid] = t
                    return self._admit(tid, t)
            if not create:
                raise KeyError(tid)
            t = _TenantState(store=store, resident=True)
            if store is not None:
                # config.json now: a WAL-only restore needs it before any
                # record replays
                store.attach(self._empty_adapter())
            self._tenants[tid] = t
            self._make_room(exclude=tid)
            self._touch(tid)
            return t
        if not t.resident:
            return self._admit(tid, t)
        self._touch(tid)
        return t

    def _make_room(self, exclude: str) -> None:
        while len(self._resident) >= self.max_resident:
            victim = next(t for t in self._resident if t != exclude)
            self.evict(victim)

    def _admit(self, tid: str, t: _TenantState) -> _TenantState:
        """Page a tenant back into the arena: the store's bit-for-bit warm
        restore (snapshot + WAL replay) adopted into fresh slabs."""
        self._make_room(exclude=tid)
        arrays = meta = None
        if t.store is not None and t.store.has_state():
            fv = t.store.load_index(expect_kind="flat", device=self.device)
            arrays, meta = fv.state_dict()
        elif t.spill is not None:
            arrays, meta = t.spill
        if arrays is not None and len(meta["keys"]):
            nskeys = [tenant_key(tid, k) for k in meta["keys"]]
            alive = np.asarray(arrays["alive"], bool)
            if self._codec.lossy:
                enc = self._codec.from_storage(arrays["vectors_enc"])
                scales = arrays.get("scales")
                vecs = self._codec.decode(enc, scales)
            else:
                enc = scales = None
                vecs = np.asarray(arrays["vectors"], np.float32)
            self._arena.adopt_rows(nskeys, vecs, alive, enc=enc,
                                   scales=scales)
            self.dim = self.dim or self._arena.dim
        if meta is not None:
            t.epoch = int(meta["epoch"])
        t.spill = None
        t.resident = True
        self._touch(tid)
        self.stats["admissions"] += 1
        return t

    def admit(self, tid: str) -> None:
        """Page a tenant in explicitly (queries and mutations do it
        implicitly)."""
        self._ensure_resident(tid)

    def evict(self, tid: str) -> None:
        """Page a tenant out: snapshot its state to its store (or the host
        spill), remove its rows from the arena (canonical arrays copied
        over the others, freed slabs returned) and drop every packed
        device structure, so no stale block outlives residency."""
        t = self._tenants.get(tid)
        if t is None:
            raise KeyError(tid)
        if not t.resident:
            return
        self._snapshot_tenant(tid, t)
        self._arena.remove_rows(~self._arena.owner_mask(tid))
        self._drop_derived()
        t.resident = False
        self._resident.pop(tid, None)
        self.stats["evictions"] += 1

    def _snapshot_tenant(self, tid: str, t: _TenantState) -> None:
        fv = self._adapter(tid, t)
        if t.store is not None:
            t.store.snapshot(fv)
            t.since_snapshot = 0
            self.stats["snapshots"] += 1
        else:
            t.spill = fv.state_dict()

    def flush(self) -> None:
        """Snapshot every resident tenant (shutdown durability)."""
        for tid in list(self._resident):
            self._snapshot_tenant(tid, self._tenants[tid])

    def _drop_derived(self) -> None:
        """Invalidate every device-derived structure: packed blocks, gid
        maps, scale tables and per-tenant slab tables. Called on evict
        (and by every arena mutation through ``_invalidate``)."""
        self._arena._invalidate()

    # ------------------------------------------------------------ mutation
    def _wal(self, t: _TenantState, op: str, meta: dict,
             arrays: dict | None = None) -> None:
        if t.store is not None:
            t.store.wal_append(op, epoch=t.epoch, meta=meta, arrays=arrays)

    def _finish_mutation(self, tid: str, t: _TenantState) -> None:
        t.epoch += 1
        self._epoch += 1
        t.since_snapshot += 1
        if (self.snapshot_every is not None
                and t.since_snapshot >= self.snapshot_every):
            self._snapshot_tenant(tid, t)

    def insert(self, tid: str, key: str, value) -> None:
        """Upsert one (key, vector) into a tenant's namespace."""
        self._validate_id(key, "key")
        t = self._ensure_resident(tid, create=True)
        v = np.asarray(value, np.float32)
        self._wal(t, "insert", {"key": key}, {"vec": v})
        self._arena.upsert(tenant_key(tid, key), v.reshape(-1))
        self.dim = self.dim or self._arena.dim
        self._finish_mutation(tid, t)

    def bulk_insert(self, tid: str, keys, values) -> None:
        """Batched upsert: ONE WAL record, last-wins on in-batch
        duplicates (the collapse of the ``VectorIndex`` template)."""
        values = np.asarray(values, np.float32)
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        keys = list(keys)
        for k in keys:
            self._validate_id(k, "key")
        if len(set(keys)) != len(keys):
            last: dict = {}
            for i, k in enumerate(keys):
                last[k] = i
            keep = sorted(last.values())
            keys = [keys[i] for i in keep]
            values = values[keep]
        t = self._ensure_resident(tid, create=True)
        self._wal(t, "bulk_insert", {"keys": keys}, {"vec": values})
        self._arena.upsert_many([tenant_key(tid, k) for k in keys], values)
        self.dim = self.dim or self._arena.dim
        self._finish_mutation(tid, t)

    def update(self, tid: str, key: str, value) -> None:
        """Replace an existing key's vector. KeyError if absent."""
        t = self._ensure_resident(tid, create=True)
        if not self._arena.contains(tenant_key(tid, key)):
            raise KeyError(key)
        v = np.asarray(value, np.float32)
        self._wal(t, "update", {"key": key}, {"vec": v})
        self._arena.upsert(tenant_key(tid, key), v.reshape(-1))
        self._finish_mutation(tid, t)

    def delete(self, tid: str, key: str) -> None:
        """Soft-delete one key: never returned again, and only THIS
        tenant's epoch bumps (other tenants' caches stay valid)."""
        t = self._ensure_resident(tid)
        if not self._arena.contains(tenant_key(tid, key)):
            raise KeyError(key)
        self._wal(t, "delete", {"key": key})
        self._arena.tombstone(tenant_key(tid, key))
        self._finish_mutation(tid, t)

    def compact(self, tid: str) -> None:
        """Per-tenant secure delete: drop the tenant's tombstoned rows from
        the host arrays and the shared device blocks, publish a fresh
        snapshot of the compacted state, truncate the WAL (its records
        held the deleted vectors' insert payloads) and purge every older
        snapshot. After this the deleted rows' bytes (fp32, encoded and
        scales) exist in no arena buffer, no slab, no page and no WAL.
        Other tenants are untouched (their epochs do not move)."""
        t = self._ensure_resident(tid)
        dead = self._arena.owner_mask(tid) & ~self._arena.alive
        if dead.any():
            self._arena.remove_rows(~dead)
        t.epoch += 1                   # the bump a dedicated compact makes
        self._epoch += 1
        t.since_snapshot = 0
        if t.store is not None:
            t.store.on_compact(self._adapter(tid, t))
        elif t.spill is not None:
            t.spill = None             # the spilled pre-compact state dies

    # --------------------------------------------------------------- query
    def query_batch(self, tid: str, queries, k: int = 10, **kw):
        """One tenant, one search: [B, D] -> (keys, dists) with the
        ``VectorIndex`` shape contract (None / INF padding). Under a lossy
        codec the slab scan is asymmetric, over-fetches ``k·rerank_factor``
        and reranks exactly in fp32 from the canonical host rows."""
        self._ensure_resident(tid)
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch expects [B, D], got {q.shape}")
        rf = effective_rerank(self._codec, self.rerank_factor)
        if rf <= 1:
            d, rows = self._arena.tenant_topk(tid, q, k)
        else:
            _, cand = self._arena.tenant_topk(tid, q, k * rf)
            d, rows = self._arena.rerank_topk(q, cand, k)
        return self._rows_to_keys(rows, d, k)

    def query(self, tid: str, query, k: int = 10, **kw):
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            keys, d = self.query_batch(tid, q[None], k, **kw)
            return keys[0], d[0]
        return self.query_batch(tid, q, k, **kw)

    def query_batch_multi(self, queries, tenants, k: int = 10, **kw):
        """ONE logical search for a batch whose rows belong to DIFFERENT
        tenants (the serving layer's cross-tenant tick): rows group by
        their tenant's padded slab width L; a group of one tenant runs the
        single-tenant slab scan, a mixed group the per-query gather; the
        results come back in input order."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_batch_multi expects [B, D], "
                             f"got {q.shape}")
        tenants = list(tenants)
        if len(tenants) != q.shape[0]:
            raise ValueError("queries/tenants length mismatch")
        uniq = list(dict.fromkeys(tenants))
        if len(uniq) > self.max_resident:
            # more distinct tenants than can be co-resident: split the
            # tick into sub-batches of <= max_resident tenants and let the
            # LRU page between them; results stitch back in input order
            out_keys: list = [None] * len(tenants)
            out_dists = [None] * len(tenants)
            for j in range(0, len(uniq), self.max_resident):
                grp = set(uniq[j:j + self.max_resident])
                idx = [i for i, t in enumerate(tenants) if t in grp]
                gk, gd = self.query_batch_multi(
                    q[idx], [tenants[i] for i in idx], k, **kw)
                gd = np.asarray(gd)
                for p, i in enumerate(idx):
                    out_keys[i] = gk[p]
                    out_dists[i] = gd[p]
            return out_keys, np.stack(out_dists)
        for tid in uniq:
            self._ensure_resident(tid)
        rf = effective_rerank(self._codec, self.rerank_factor)
        kk = k * rf if rf > 1 else k
        b = q.shape[0]
        out_d = np.full((b, kk), INF, np.float32)
        out_g = np.full((b, kk), -1, np.int64)
        # group rows by padded slab width; an empty tenant raises as a
        # dedicated empty index does
        by_l: dict[int, list[int]] = {}
        for i, tid in enumerate(tenants):
            _, l_pad, _, live = self._arena.tenant_table(tid)
            if live == 0:
                raise ValueError("index is empty")
            by_l.setdefault(l_pad, []).append(i)
        for rows_idx in by_l.values():
            g_tenants = [tenants[i] for i in rows_idx]
            g_q = q[rows_idx]
            if len(set(g_tenants)) == 1:
                d, g = self._arena.tenant_topk(g_tenants[0], g_q, kk)
            else:
                tables = np.stack(
                    [self._arena.tenant_table(tid)[0]
                     for tid in g_tenants], axis=1)        # [S, B_g, L]
                d, g = self._arena.multi_topk(tables, g_q, kk)
            out_d[rows_idx] = d
            out_g[rows_idx] = g
        if rf > 1:
            out_d, out_g = self._arena.rerank_topk(q, out_g, k)
        return self._rows_to_keys(out_g, out_d, k)

    def _rows_to_keys(self, rows: np.ndarray, d: np.ndarray, k: int):
        keys = [[split_tenant_key(self._arena.key_of_row(int(r)))[1]
                 if r >= 0 else None for r in row] for row in rows]
        d = np.asarray(d)
        keys = [row_k[:k] for row_k in keys]
        return _pad_results(keys, d[:, :k], k)

    # ----------------------------------------------------------- introspect
    def size(self, tid: str) -> int:
        """Live keys of one tenant (pages it in if needed)."""
        self._ensure_resident(tid)
        return self._arena.tenant_live(tid)

    def contains(self, tid: str, key: str) -> bool:
        try:
            self._ensure_resident(tid)
        except KeyError:
            return False
        return self._arena.contains(tenant_key(tid, key))

    def keys(self, tid: str) -> list[str]:
        """One tenant's live keys in insertion order."""
        self._ensure_resident(tid)
        pre = tid + NS_SEP
        return [k.partition(NS_SEP)[2]
                for i, k in enumerate(self._arena.key_list)
                if self._arena.alive[i] and k.startswith(pre)]

    def pool_stats(self) -> dict:
        """Occupancy and paging counters (logging, chip_smoke)."""
        arena = self._arena
        slabs = sum(len(o) for o in arena._slab_owner)
        owned = sum(sum(o is not None for o in sh)
                    for sh in arena._slab_owner)
        return {**self.stats, "tenants": len(self._tenants),
                "resident": len(self._resident),
                "arena_rows": arena.row_count, "arena_live": arena.size,
                "slabs": slabs, "slabs_owned": owned,
                "slab_rows": self.slab_rows,
                "arena_bytes": arena.arena_device_bytes()}
