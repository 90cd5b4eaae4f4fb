"""Keyed mutable row substrate of the flat and IVF indexes, and the
sharded fan-out search, ported from ``repro/core/sharded.py``.

Three layers of state:

  * **canonical** (host, numpy; independent of the shard count):
    append-only fp32 rows ``[T, D]`` in insertion order, the row -> key
    table and the ``alive`` tombstone mask; under a lossy codec also the
    encoded rows and per-row scales, encoded ONCE at ingest (after cosine
    normalization) — the fp32 rows are then their exact decode. This is
    what a snapshot persists, so a snapshot taken at 8 shards restores
    onto 1 and back: placement is derived, not stored.
  * **placement** (derived): ``shard_of_key`` routing (stable blake2b)
    and per-shard slot tables with free-slot reuse, so block shapes stay
    put under churn; ``compact`` and ``restore`` re-derive it.
  * **device** (lazy, rebuilt on the first search after a mutation): at
    one shard a ``FlatIndex`` over the live rows; at S shards one row
    block [R_s, D] and gid map [R_s] a shard, R_s that shard's own slot
    count, each on its shard's device (``shard_devices``). Lossy rows
    upload encoded, as they are.

The reference runs the S shards as one ``shard_map`` program over a mesh
of the process's devices, so it pads every shard's block to the largest
shard's R and over-fetches the padding too. The port is one process that
holds a tensor a shard, so nothing is padded: a search copies the query
batch to each shard's device once, queues every shard's
``ops.flat_topk`` launch (``k + slack_s`` rows, slack_s that shard's own
free slots, then gid < 0 masked to 3e38 and the list trimmed to k)
before any host read, and merges the shards' [B, k] lists on the first
shard's device through the tree of ``distributed/collectives.py``. The
keys are the same: the rows a shard drops are dead ones.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from repro_torch.core.codec import (VectorCodec, device_rows, get_codec,
                                    rerank_exact)
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.distributed.collectives import hierarchical_topk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k
from repro_torch.utils import resolve_device

INF = 3.0e38                   # == the reference's np.float32(3e38)
SHARD_AXIS = "shard"
# a comma list of n_shards devices (repeats allowed) that places the
# shards of a CUDA index, e.g. "cuda:0,cuda:0,cuda:0,cuda:0"
SHARD_DEVICES_ENV = "REPRO_TORCH_SHARD_DEVICES"


def resolve_wire_bf16(flag: bool | None) -> bool:
    """A per-call/per-index ``wire_bf16`` knob: explicit values win; None
    falls back to the REPRO_WIRE_BF16 toggle (off by default: a bf16
    wire halves the merge's bytes but costs bitwise parity with the
    1-shard path)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_WIRE_BF16", "0") == "1"


# re-layout the slot tables when free (tombstoned, reusable) slots exceed
# this fraction of block capacity: bounds the top-k slack (see pack())
REPACK_FREE_FRACTION = 0.25


def shard_of_key(key: str, n_shards: int) -> int:
    """Deterministic key -> owning shard (stable blake2b, never Python
    ``hash``): WAL replay and a resharded restore route as the live index
    did."""
    if n_shards <= 1:
        return 0
    h = hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_shards


def _env_devices() -> list[torch.device] | None:
    spec = os.environ.get(SHARD_DEVICES_ENV, "").strip()
    if not spec:
        return None
    return [torch.device(x.strip()) for x in spec.split(",")]


def max_shards(device=None) -> int | None:
    """How many shards ``shard_devices`` can place on ``device``'s type
    without raising: None (any number) on the CPU; on CUDA the length of
    ``REPRO_TORCH_SHARD_DEVICES`` when it is set, else the card count."""
    if resolve_device(device).type != "cuda":
        return None
    env = _env_devices()
    return len(env) if env is not None else torch.cuda.device_count()


def shard_devices(n_shards: int, device=None) -> list[torch.device]:
    """The device of each of ``n_shards`` shards of an index on
    ``device`` (default cuda) — the port's counterpart of the reference's
    ``shard_mesh``.

    CPU: every shard on the CPU, where the kernels' plain versions run.
    CUDA: shard s on ``cuda:s``; fewer cards than shards raises, naming
    the recipe — ``REPRO_TORCH_SHARD_DEVICES``, a comma list of
    ``n_shards`` CUDA devices (repeats allowed), which this function alone
    reads. There is no quiet fallback to repeated or CPU devices."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_shards
    n_dev = torch.cuda.device_count()
    env = _env_devices()
    if env is None:
        if n_shards > n_dev:
            raise ValueError(
                f"n_shards={n_shards} needs {n_shards} CUDA devices, found "
                f"{n_dev}; to place several shards on one card set "
                f"{SHARD_DEVICES_ENV} to a comma list of {n_shards} devices "
                f"(e.g. {','.join(['cuda:0'] * n_shards)})")
        return [torch.device("cuda", s) for s in range(n_shards)]
    if len(env) != n_shards:
        raise ValueError(f"{SHARD_DEVICES_ENV} lists {len(env)} devices for "
                         f"n_shards={n_shards}")
    out = []
    for d in env:
        if d.type != "cuda" or (d.index or 0) >= n_dev:
            raise ValueError(f"{SHARD_DEVICES_ENV}: {d} is not one of the "
                             f"{n_dev} CUDA devices")
        out.append(torch.device("cuda", d.index or 0))
    return out


def per_device(q: torch.Tensor, devices: list[torch.device]) -> dict:
    """The query batch on each distinct shard device, copied once a
    device."""
    return {dev: q.to(dev, non_blocking=True) for dev in dict.fromkeys(devices)}


def normalized(q: torch.Tensor) -> torch.Tensor:
    """Cosine queries as ``FlatIndex.query`` normalizes them."""
    return q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


# ---------------------------------------------------------------------------
# fan-out search: per-shard fused top-k + tree merge
# ---------------------------------------------------------------------------
def trim_merge_width(d: torch.Tensor, ids: torch.Tensor, k: int,
                     inf: float = INF) -> tuple[torch.Tensor, torch.Tensor]:
    """Bring one shard's masked candidates to exactly the k-wide merge
    format: re-select k when over-fetched (a stable sort: ties keep their
    order, as ``lax.top_k``), pad with (inf, -1) when short. Callers mask
    invalid candidates to ``inf`` first."""
    kk = d.shape[1]
    if kk > k:
        return smallest_k(d, ids, k)
    if kk < k:
        b = d.shape[0]
        d = torch.cat([d, torch.full((b, k - kk), inf, dtype=d.dtype,
                                     device=d.device)], dim=1)
        ids = torch.cat([ids, torch.full((b, k - kk), -1, dtype=ids.dtype,
                                         device=ids.device)], dim=1)
    return d, ids


def _quantize_slack(slack: int) -> int:
    """Round a shard's dead-slot count up to a power of two (the
    reference keys its compiled fan-out on it; kept so that a shard's
    over-fetch changes only when its free slots pass a power of two)."""
    if slack <= 0:
        return 0
    return 1 << (slack - 1).bit_length()


# incremented on every block upload: steady-state sharded search uploads
# no row block
PLACE_COUNT = 0


@dataclasses.dataclass(frozen=True)
class ExactBlocks:
    """Row blocks placed on the shards' devices, built once a mutation
    epoch and searched until the index mutates: one [R_s, D] block and its
    [R_s] gid map a shard at the shard's own row count (gid -1: a free
    slot, or the one zero row of an empty shard), with the [R_s] decode
    scales of int8 rows. ``slack[s]`` is shard s's dead rows,
    ``_quantize_slack``-rounded. Both the exact phase of the graph
    backends and ``ShardedRows``' own packed rows take this form."""
    devices: list
    blocks: list                 # [R_s, D] tensor a shard, on its device
    gids: list                   # [R_s] int32 a shard
    slack: list                  # quantized over-fetch bound a shard
    n_rows: int                  # live rows across the shards
    scales: list | None = None   # [R_s] f32 a shard (int8 rows)


def place_blocks(blocks: list, gids: list, devices: list,
                 scales: list | None = None):
    """Upload each shard's [R_s, D] block and [R_s] gid map (and, for
    int8 rows, its [R_s] scales), shard s on ``devices[s]`` -> lists."""
    global PLACE_COUNT
    PLACE_COUNT += 1
    bl = [device_rows(blocks[s], dev) for s, dev in enumerate(devices)]
    gi = [torch.from_numpy(np.ascontiguousarray(gids[s])).to(dev)
          for s, dev in enumerate(devices)]
    sc = (None if scales is None else
          [torch.from_numpy(np.ascontiguousarray(scales[s])).to(dev)
           for s, dev in enumerate(devices)])
    return bl, gi, sc


def fanout_topk(placed: ExactBlocks, q: torch.Tensor, k: int, *,
                metric: str, wire_bf16: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prepared queries [B, D] f32 -> (dists [B, k], gids [B, k]) on the
    first shard's device, missing slots (INF, -1). Each shard's
    ``ops.flat_topk`` fetches ``k + slack[s]`` rows (the fused kernel
    cannot skip free slots), masks gid < 0, and trims to k; every launch
    is queued before the merge."""
    qs = per_device(q, placed.devices)
    parts = []
    for s, (blk, gid) in enumerate(zip(placed.blocks, placed.gids)):
        kk = min(k + placed.slack[s], blk.shape[0])
        d, i = ops.flat_topk(blk, qs[blk.device], kk, metric=metric,
                             scales=None if placed.scales is None
                             else placed.scales[s])
        g = gid[i.long()]
        d = torch.where(g >= 0, d, INF)
        d, g = trim_merge_width(d, g, k)
        parts.append((d, torch.where(d >= INF, -1, g)))
    return hierarchical_topk(parts, k, wire_bf16=wire_bf16,
                             tie_break_ids=True)


def build_exact_blocks(groups, dim: int, devices: list, *,
                       normalize: bool = False) -> ExactBlocks | None:
    """Host repack + upload of per-shard row groups -> placed blocks.

    groups: [(vectors [n_s, D], gids [n_s])], one entry a shard (n_s may
    be 0: that shard gets one zero row of gid -1). None when every group
    is empty (nothing touches a device)."""
    total = sum(v.shape[0] for v, _ in groups)
    if total == 0:
        return None
    blocks, gids = [], []
    for v, g in groups:
        if v.shape[0]:
            blocks.append(normalize_rows(v) if normalize
                          else np.asarray(v, np.float32))
            gids.append(np.asarray(g, np.int32))
        else:
            blocks.append(np.zeros((1, dim), np.float32))
            gids.append(np.full(1, -1, np.int32))
    bl, gi, _ = place_blocks(blocks, gids, devices)
    return ExactBlocks(devices=list(devices), blocks=bl, gids=gi,
                       slack=[int(v.shape[0] == 0) for v, _ in groups],
                       n_rows=total)


def exact_topk_blocks(placed: ExactBlocks, queries, k: int, *, metric: str,
                      wire_bf16: bool | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Query already-placed blocks: no host row bytes move on the steady
    state, only the query batch."""
    q = torch.as_tensor(np.asarray(queries, np.float32),
                        device=placed.devices[0])
    if metric == "cosine":
        q = normalized(q)
    d, g = fanout_topk(placed, q.contiguous(), k, metric=metric,
                       wire_bf16=resolve_wire_bf16(wire_bf16))
    return d.cpu().numpy(), g.cpu().numpy()


def fanout_exact_topk(groups, queries, k: int, devices: list, *,
                      metric: str, normalize: bool = False,
                      wire_bf16: bool | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """One-shot sharded exact search over explicit per-shard row groups
    (``build_exact_blocks`` + ``exact_topk_blocks``; callers with a
    mutation epoch cache the blocks instead). queries [B, D] -> (dists
    [B, k], gids [B, k]), missing slots (INF, -1)."""
    queries = np.asarray(queries, np.float32)
    placed = build_exact_blocks(groups, queries.shape[1], devices,
                                normalize=normalize)
    if placed is None:
        b = queries.shape[0]
        return (np.full((b, k), INF, np.float32),
                np.full((b, k), -1, np.int32))
    return exact_topk_blocks(placed, queries, k, metric=metric,
                             wire_bf16=wire_bf16)


# ---------------------------------------------------------------------------
# the mutable substrate
# ---------------------------------------------------------------------------
class ShardedRows:
    """Keyed mutable row storage over ``n_shards`` shards. All mutators
    are host-side and cheap; the device rows are packed lazily on the
    first search after a mutation."""

    def __init__(self, *, n_shards: int = 1, metric: str = "cosine",
                 dim: int | None = None, normalize_on_pack: bool = True,
                 codec: VectorCodec | str | None = None, device=None,
                 wire_bf16: bool | None = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.metric = metric
        self.dim = dim
        # None -> REPRO_WIRE_BF16 (resolve_wire_bf16)
        self.wire_bf16 = wire_bf16
        # cosine normalization by the substrate (flat semantics): at pack
        # time for fp32 rows, at ingest before the one encode for lossy
        # ones. IVF normalizes at insert instead and passes False, so its
        # rows are taken as they come.
        self.normalize_on_pack = normalize_on_pack
        self.device = resolve_device(device)
        self.devices = (shard_devices(n_shards, self.device) if n_shards > 1
                        else [self.device])
        self.codec = (codec if isinstance(codec, VectorCodec)
                      else get_codec(codec or "fp32"))
        self._vecs = np.zeros((0, dim or 0), np.float32)
        self._enc = (np.zeros((0, dim or 0), self.codec.enc_dtype)
                     if self.codec.lossy else None)
        self._scales = (np.zeros(0, np.float32)
                        if self.codec.uses_scales else None)
        self._keys: list[str] = []
        self._key2row: dict[str, int] = {}
        self._alive = np.zeros(0, bool)
        # placement
        self._row_shard = np.zeros(0, np.int32)
        self._row_slot = np.zeros(0, np.int32)
        self._slots: list[list[int]] = [[] for _ in range(n_shards)]
        self._free: list[list[int]] = [[] for _ in range(n_shards)]
        # device (lazy)
        self._placed: ExactBlocks | None = None    # S > 1
        self._flat = None                          # S == 1: FlatIndex
        self._live_rows: np.ndarray | None = None

    # ------------------------------------------------------------ canonical
    @property
    def vectors(self) -> np.ndarray:
        return self._vecs

    @property
    def encoded(self) -> np.ndarray | None:
        """Canonical codec-encoded rows [T, D] (None for fp32)."""
        return self._enc

    @property
    def scales(self) -> np.ndarray | None:
        """Canonical per-row decode scales [T] (int8 codec only)."""
        return self._scales

    @property
    def alive(self) -> np.ndarray:
        return self._alive

    @property
    def key_list(self) -> list[str]:
        return self._keys

    @property
    def key2row(self) -> dict[str, int]:
        return self._key2row

    @property
    def size(self) -> int:
        return len(self._key2row)

    @property
    def row_count(self) -> int:
        return len(self._keys)

    def live_keys(self) -> list[str]:
        return [k for i, k in enumerate(self._keys) if self._alive[i]]

    def key_of_row(self, row: int) -> str:
        return self._keys[row]

    def placement_of_row(self, row: int) -> tuple[int, int]:
        """-> (shard, slot) of a live row."""
        return int(self._row_shard[row]), int(self._row_slot[row])

    def shard_stats(self) -> list[dict]:
        """Per-shard occupancy: live rows, free slots, block capacity."""
        out = []
        for s in range(self.n_shards):
            free = len(self._free[s])
            out.append({"shard": s, "slots": len(self._slots[s]),
                        "free": free, "live": len(self._slots[s]) - free})
        return out

    # ------------------------------------------------------------ mutation
    def _invalidate(self) -> None:
        self._placed = None
        self._flat = None
        self._live_rows = None

    def _ensure_dim(self, d: int) -> None:
        if self.dim is None:
            self.dim = d
            self._vecs = np.zeros((0, d), np.float32)
            if self._enc is not None:
                self._enc = np.zeros((0, d), self.codec.enc_dtype)

    def _ingest(self, vecs: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """Raw fp32 rows -> (canonical fp32, encoded, scales). Lossy
        codecs quantize here, once, after cosine normalization (when the
        substrate normalizes); fp32 rows pass through untouched."""
        vecs = np.asarray(vecs, np.float32)
        if not self.codec.lossy:
            return vecs, None, None
        if self.normalize_on_pack and self.metric == "cosine":
            vecs = normalize_rows(vecs)
        enc, scales = self.codec.encode(vecs)
        return self.codec.decode(enc, scales), enc, scales

    def _claim_slot(self, shard: int, row: int) -> int:
        free = self._free[shard]
        if free:
            slot = free.pop()
            self._slots[shard][slot] = row
        else:
            slot = len(self._slots[shard])
            self._slots[shard].append(row)
        return slot

    def _release_row(self, row: int) -> None:
        self._alive[row] = False
        s, slot = int(self._row_shard[row]), int(self._row_slot[row])
        self._slots[s][slot] = -1
        self._free[s].append(slot)

    def _append_enc(self, enc: np.ndarray | None,
                    scales: np.ndarray | None) -> None:
        if self._enc is not None:
            self._enc = np.concatenate([self._enc, enc])
        if self._scales is not None:
            self._scales = np.concatenate(
                [self._scales, np.asarray(scales, np.float32)])

    def upsert(self, key: str, vec: np.ndarray) -> None:
        vec = np.asarray(vec, np.float32).reshape(-1)
        self.upsert_many([key], vec[None])

    def upsert_many(self, keys: list[str], vecs: np.ndarray) -> None:
        vecs = np.asarray(vecs, np.float32)
        self._ensure_dim(vecs.shape[1])
        vecs, enc, scales = self._ingest(vecs)
        # pop as we release: a pre-existing key repeated WITHIN the batch
        # must free its old slot exactly once
        for key in keys:
            old = self._key2row.pop(key, None)
            if old is not None:
                self._release_row(old)
        base = len(self._keys)
        n = len(keys)
        self._vecs = np.concatenate([self._vecs, vecs])
        self._append_enc(enc, scales)
        self._keys.extend(keys)
        self._alive = np.concatenate([self._alive, np.ones(n, bool)])
        shards = np.zeros(n, np.int32)
        slots = np.zeros(n, np.int32)
        for j, key in enumerate(keys):
            self._key2row[key] = base + j
            shards[j] = shard_of_key(key, self.n_shards)
            slots[j] = self._claim_slot(int(shards[j]), base + j)
        self._row_shard = np.concatenate([self._row_shard, shards])
        self._row_slot = np.concatenate([self._row_slot, slots])
        self._invalidate()

    def tombstone(self, key: str) -> None:
        self._release_row(self._key2row.pop(key))
        self._invalidate()

    def contains(self, key: str) -> bool:
        return key in self._key2row

    def compact(self) -> None:
        """Physically drop tombstoned rows: the canonical arrays re-pack
        over live rows and the slot tables are rebuilt dense. After this
        a deleted row's bytes — the fp32 decode AND the encoded bytes +
        scale — exist in no host array and in no shard's device block."""
        live = np.flatnonzero(self._alive)
        vecs = np.ascontiguousarray(self._vecs[live])
        keys = [self._keys[i] for i in live]
        enc = (np.ascontiguousarray(self._enc[live])
               if self._enc is not None else None)
        scales = (np.ascontiguousarray(self._scales[live])
                  if self._scales is not None else None)
        self._reset_layout(vecs, keys, np.ones(live.size, bool),
                           enc=enc, scales=scales)

    def _reset_layout(self, vecs: np.ndarray, keys: list[str],
                      alive: np.ndarray, enc: np.ndarray | None = None,
                      scales: np.ndarray | None = None) -> None:
        """Adopt canonical arrays and re-derive placement from scratch
        (compaction, restore and resharding land here)."""
        self._vecs = np.asarray(vecs, np.float32)
        if self._enc is not None:
            if enc is None:
                raise ValueError(
                    f"{self.codec.name} rows need their encoded arrays; "
                    "got fp32-only state (cross-dtype restore?)")
            self._enc = np.asarray(enc, self.codec.enc_dtype)
        if self._scales is not None:
            self._scales = np.asarray(scales, np.float32)
        if self._vecs.shape[1]:
            self.dim = int(self._vecs.shape[1])
        self._keys = list(keys)
        self._alive = np.asarray(alive, bool).copy()
        self._key2row = {k: i for i, k in enumerate(self._keys)
                         if self._alive[i]}
        n = len(self._keys)
        self._row_shard = np.full(n, -1, np.int32)
        self._row_slot = np.full(n, -1, np.int32)
        self._slots = [[] for _ in range(self.n_shards)]
        self._free = [[] for _ in range(self.n_shards)]
        for row in range(n):
            if not self._alive[row]:
                continue                 # dead rows own no slot
            shard = shard_of_key(self._keys[row], self.n_shards)
            self._row_shard[row] = shard
            self._row_slot[row] = self._claim_slot(shard, row)
        self._invalidate()

    def restore(self, vecs: np.ndarray, keys: list[str],
                alive: np.ndarray) -> None:
        """Inverse of the canonical accessors for fp32 rows; placement is
        re-derived, which is why a snapshot reshards freely."""
        if self.codec.lossy:
            raise ValueError(
                f"{self.codec.name} rows restore from encoded state "
                "(restore_encoded); got fp32-only state — the store was "
                "written by a different storage dtype")
        self._reset_layout(vecs, keys, alive)

    def restore_encoded(self, enc: np.ndarray, scales: np.ndarray | None,
                        keys: list[str], alive: np.ndarray) -> None:
        """Adopt snapshotted encoded rows (+ scales) as canonical and
        re-derive the fp32 side by decoding — the encoded array is never
        re-derived, so restore is bit for bit."""
        enc = self.codec.from_storage(enc)
        self._reset_layout(self.codec.decode(enc, scales), keys, alive,
                           enc=enc, scales=scales)

    # --------------------------------------------------------------- pack
    def _maybe_relayout(self) -> None:
        total = sum(len(s) for s in self._slots)
        free = sum(len(f) for f in self._free)
        if total and free / total > REPACK_FREE_FRACTION:
            # too many dead slots: re-derive a dense layout (the device
            # blocks are being rebuilt anyway)
            self._reset_layout(self._vecs, self._keys, self._alive)

    def pack(self):
        """(Re)build the device rows over the live rows.

        S == 1 -> a ``FlatIndex``: fp32 rows normalized for cosine
                  (``FlatIndex.build``) unless the substrate takes them as
                  they come, lossy rows as their encoded bytes + scales.
        S > 1  -> an ``ExactBlocks``: a slot-ordered block [R_s, D] of the
                  codec's rows at the shard's own slot count, its gid map
                  [R_s] (and scales [R_s]) on each shard's device, with
                  each shard's quantized dead-slot slack.
        """
        live = np.flatnonzero(self._alive)
        if live.size == 0:
            raise ValueError("index is empty")
        lossy = self.codec.lossy
        if self.n_shards == 1:
            if self._flat is None:
                from repro_torch.core.flat import FlatIndex
                self._live_rows = live
                if lossy:
                    self._flat = FlatIndex(
                        vectors=device_rows(self._enc[live], self.device),
                        metric=self.metric,
                        scales=(device_rows(self._scales[live], self.device)
                                if self._scales is not None else None))
                elif self.normalize_on_pack:
                    self._flat = FlatIndex.build(self._vecs[live],
                                                 metric=self.metric,
                                                 device=self.device)
                else:
                    self._flat = FlatIndex(
                        vectors=device_rows(self._vecs[live], self.device),
                        metric=self.metric)
            return self._flat
        if self._placed is None:
            self._maybe_relayout()
            rows_src = self._enc if lossy else self._vecs
            blocks, gids = [], []
            scl = [] if self._scales is not None else None
            slack = []
            for s in range(self.n_shards):
                table = np.asarray(self._slots[s], np.int64)
                r = max(table.size, 1)      # an empty shard: one zero row
                occ = np.flatnonzero(table >= 0)     # occupied slots only
                blk = np.zeros((r, self.dim or 1), rows_src.dtype)
                gid = np.full(r, -1, np.int32)
                blk[occ] = rows_src[table[occ]]
                gid[occ] = table[occ]
                if not lossy and self.normalize_on_pack \
                        and self.metric == "cosine":
                    # free slots stay zero (norm clamped)
                    blk = normalize_rows(blk)
                blocks.append(blk)
                gids.append(gid)
                if scl is not None:
                    sc = np.zeros(r, np.float32)
                    sc[occ] = self._scales[table[occ]]
                    scl.append(sc)
                slack.append(_quantize_slack(r - occ.size))
            bl, gi, sc = place_blocks(blocks, gids, self.devices, scl)
            self._placed = ExactBlocks(
                devices=self.devices, blocks=bl, gids=gi, slack=slack,
                n_rows=int(live.size), scales=sc)
        return self._placed

    # -------------------------------------------------------------- search
    def topk(self, queries: np.ndarray, k: int
             ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over live rows (asymmetric under a lossy codec:
        fp32 query vs encoded rows) -> (dists, global row ids).

        S == 1 returns ``min(k, live)`` columns (callers pad); S > 1
        always returns k columns with missing slots as (INF, -1)."""
        q = np.asarray(queries, np.float32)
        if self.n_shards == 1:
            flat = self.pack()
            d, i = flat.query(q, min(k, flat.n))
            return d.cpu().numpy(), self._live_rows[i.cpu().numpy()]
        placed = self.pack()
        qt = torch.as_tensor(q, device=self.devices[0])
        if self.metric == "cosine" and self.normalize_on_pack:
            qt = normalized(qt)
        d, g = fanout_topk(placed, qt.contiguous(), k, metric=self.metric,
                           wire_bf16=resolve_wire_bf16(self.wire_bf16))
        return d.cpu().numpy(), g.cpu().numpy()

    def rerank_topk(self, queries: np.ndarray, gids: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact fp32 re-scoring of over-fetched candidates against the
        canonical host rows: the second half of the lossy search."""
        return rerank_exact(self._vecs, queries, gids, k,
                            metric=self.metric)

    def device_block_bytes(self) -> int:
        """Bytes the packed device representation holds for the current
        live set (rows + scale table; at S > 1 also the gid maps): the
        codec's device footprint."""
        packed = self.pack()
        if self.n_shards == 1:
            tensors = [packed.vectors, packed.scales]
        else:
            tensors = [*packed.blocks, *packed.gids, *(packed.scales or [])]
        return sum(t.numel() * t.element_size()
                   for t in tensors if t is not None)
