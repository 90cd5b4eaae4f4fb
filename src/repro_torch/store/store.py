"""``IndexStore`` — the durable home of one ``VectorIndex``, ported from
``repro/store/store.py`` (host numpy and files, the same on every device).

MeMemo's IndexedDB layer is what lets the browser restart with the user's
private index intact, without the rebuild. One store directory owns one
index:

    store/
      config.json          index kind + construction params (written once)
      wal.log              write-ahead mutation log (store/wal.py)
      snap_<epoch>/        chunked snapshots (store/snapshot.py), newest wins

Lifecycle:

    store = IndexStore("store/", snapshot_every=1000)
    idx = make_index("hnsw", store=store)     # cold: attach; warm: restore
    idx.insert/update/delete(...)             # WAL-logged before applying
    store.snapshot(idx)                       # durable point; truncates WAL
    ...crash...
    idx = make_index("hnsw", store=IndexStore("store/"))   # snapshot + WAL
                                              # replay == the live index,
                                              # bit for bit, same epoch

Invariants:
  * every mutation record lands in the WAL before index state changes;
  * restore = latest snapshot + replay of WAL records whose ``epoch``
    (mutation_epoch before the op) >= the snapshot's epoch — so a crash
    between "snapshot written" and "WAL truncated" replays idempotently;
  * ``compact()`` physically rewrites the store so tombstoned vectors'
    bytes appear in NO file under the directory — deletion is physical,
    not a tombstone bit (the privacy property).

Backends serialize canonical state, independent of placement, so a store
written at one shard count restores at another (``load_index(n_shards=)``
reshards on restore).
"""
from __future__ import annotations

import json
import os
import shutil

from repro_torch.store import snapshot as snapmod
from repro_torch.store.wal import WalCorruption, WriteAheadLog

CONFIG_NAME = "config.json"
WAL_NAME = "wal.log"
SNAP_PREFIX = "snap_"
FORMAT_VERSION = 1
KEEP_SNAPSHOTS = 2          # retained by routine GC; compaction keeps one


class IndexStore:
    """Durability orchestrator for one ``VectorIndex``.

    Parameters
    ----------
    root:           store directory (created if absent).
    snapshot_every: auto-snapshot after this many mutations (None = only
                    explicit ``snapshot()`` calls; the WAL still makes
                    every mutation durable in between).
    page_bytes:     snapshot page size (store/snapshot.py).
    """

    def __init__(self, root: str, *, snapshot_every: int | None = None,
                 page_bytes: int = 4 << 20):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        self.snapshot_every = snapshot_every
        self.page_bytes = page_bytes
        self.wal = WriteAheadLog(os.path.join(self.root, WAL_NAME))
        self._since_snapshot = 0

    # ----------------------------------------------------------- listing
    def _config_path(self) -> str:
        return os.path.join(self.root, CONFIG_NAME)

    def has_state(self) -> bool:
        """True once an index has ever been attached here — the signal
        ``make_index(store=...)`` uses to restore instead of create."""
        return os.path.exists(self._config_path())

    def snapshots(self) -> list[str]:
        """Published snapshot directory names, oldest -> newest (the
        zero-padded epoch in the name makes lexical order epoch order)."""
        out = []
        for d in sorted(os.listdir(self.root)):
            if (d.startswith(SNAP_PREFIX) and not d.endswith(".tmp")
                    and os.path.exists(os.path.join(
                        self.root, d, snapmod.MANIFEST_NAME))):
                out.append(d)
        return out

    # ------------------------------------------------------------ attach
    def attach(self, index) -> None:
        """Bind ``index`` to this store: future mutations are WAL-logged.
        Writes ``config.json`` on first attach; later attaches validate
        the stored kind."""
        cfgp = self._config_path()
        if not os.path.exists(cfgp):
            cfg = {"format_version": FORMAT_VERSION, "kind": index.kind,
                   "params": index.config_dict()}
            tmp = cfgp + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cfg, f, indent=1)
            os.replace(tmp, cfgp)
        else:
            with open(cfgp) as f:
                stored = json.load(f)
            if stored["kind"] != index.kind:
                raise ValueError(
                    f"store at {self.root} holds a {stored['kind']!r} "
                    f"index; cannot attach a {index.kind!r}")
        index._store = self
        self._since_snapshot = 0

    # --------------------------------------------------------------- WAL
    def wal_append(self, op: str, *, epoch: int, meta: dict | None = None,
                   arrays: dict | None = None) -> None:
        self.wal.append(op, epoch=epoch, meta=meta, arrays=arrays)

    def notify_mutation(self, index) -> None:
        """Called by the index after every applied mutation; drives the
        ``snapshot_every`` policy."""
        self._since_snapshot += 1
        if (self.snapshot_every is not None
                and self._since_snapshot >= self.snapshot_every):
            self.snapshot(index)

    # ---------------------------------------------------------- snapshot
    def snapshot(self, index) -> str | None:
        """Write a durable snapshot of ``index`` and truncate the WAL
        (its records are now redundant). Crash-ordering: the snapshot is
        published (atomic rename) BEFORE the WAL is cut, and replay skips
        records the snapshot already covers — so dying between the two
        steps is harmless."""
        if index._row_count() == 0 and index.mutation_epoch == 0:
            return None                       # nothing ever happened
        epoch = index.mutation_epoch
        path = os.path.join(self.root, f"{SNAP_PREFIX}{epoch:012d}")
        if os.path.exists(path):
            # a snapshot at this epoch is already durable; the WAL is
            # left as it is (its records at this epoch replay as no-ops).
            # GC (old snapshots + crash debris) still runs.
            self._gc()
            self._since_snapshot = 0
            return path
        arrays, meta = index.state_dict()
        snapmod.write_snapshot(
            path, kind=index.kind, config=index.config_dict(),
            epoch=epoch, arrays=arrays, meta=meta,
            page_bytes=self.page_bytes)
        self.wal.reset()
        self._gc()
        self._since_snapshot = 0
        return path

    def _gc(self) -> None:
        snaps = self.snapshots()
        for d in snaps[:-KEEP_SNAPSHOTS]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
        for d in os.listdir(self.root):       # crash debris from mid-write
            if d.startswith(SNAP_PREFIX) and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)

    # ----------------------------------------------------------- restore
    def load_index(self, expect_kind: str | None = None,
                   n_shards: int | None = None,
                   expect_dtype: str | None = None, *, device=None):
        """Warm restore onto ``device`` (default cuda): latest snapshot +
        WAL replay, then attach.

        The result is bit-for-bit equal to the index that was live when
        the last WAL record landed — including ``mutation_epoch``, so
        epoch-keyed consumers (the RetrievalEngine LRU) keep their
        invalidation semantics across restarts. The stored construction
        params win over the caller's.

        ``n_shards`` overrides the stored shard count: resharding on
        restore. Without an override, a stored count above the shards
        ``device`` can place (``sharded.max_shards``: the CUDA cards, or
        the length of ``REPRO_TORCH_SHARD_DEVICES``) is clamped to it,
        with a log line, as the reference clamps to its device count —
        the shard count is an execution resource, not data.
        ``expect_dtype``: the storage dtype determines the stored bytes
        themselves (encoded pages cannot be transcoded), so a mismatch
        with the stored codec is rejected."""
        from repro_torch.core.index import make_index
        from repro_torch.core.sharded import max_shards
        from repro_torch.utils import logger

        cfgp = self._config_path()
        if not os.path.exists(cfgp):
            raise FileNotFoundError(
                f"store at {self.root} has no {CONFIG_NAME}; "
                "nothing to restore")
        with open(cfgp) as f:
            cfg = json.load(f)
        if expect_kind is not None and cfg["kind"] != expect_kind:
            raise ValueError(
                f"store at {self.root} holds a {cfg['kind']!r} index, "
                f"not {expect_kind!r}")
        params = dict(cfg["params"])
        stored_dtype = params.get("dtype", "fp32")
        if expect_dtype is not None and expect_dtype != stored_dtype:
            raise ValueError(
                f"store at {self.root} holds a {stored_dtype!r}-encoded "
                f"index; cannot restore it as dtype={expect_dtype!r} — "
                "storage dtype is part of the stored bytes (encoded "
                "snapshot pages cannot be transcoded). Omit dtype= to "
                f"keep {stored_dtype!r}, or re-ingest the corpus into a "
                "fresh store.")
        cap = max_shards(device)
        if n_shards is not None:
            params["n_shards"] = int(n_shards)
        elif cap is not None and params.get("n_shards", 1) > cap:
            logger.info(
                f"store at {self.root}: stored n_shards="
                f"{params['n_shards']} exceeds the {cap} shard device(s); "
                "resharding on restore")
            params["n_shards"] = cap
        idx = make_index(cfg["kind"], device=device, **params)

        snaps = self.snapshots()
        if snaps:
            manifest, arrays = snapmod.read_snapshot(
                os.path.join(self.root, snaps[-1]))
            idx.restore_state(arrays, manifest["meta"])
            if idx.mutation_epoch != manifest["epoch"]:
                raise WalCorruption(
                    f"snapshot {snaps[-1]} meta epoch "
                    f"{manifest['epoch']} != restored index epoch "
                    f"{idx.mutation_epoch}")

        self.wal.repair()                     # cut any torn tail record
        for header, arrays in self.wal.records():
            ep = int(header["epoch"])
            if ep < idx.mutation_epoch:
                continue                      # already inside the snapshot
            if ep > idx.mutation_epoch:
                raise WalCorruption(
                    f"WAL gap: record epoch {ep} is ahead of index epoch "
                    f"{idx.mutation_epoch}")
            try:
                self._apply(idx, header, arrays)
            except RuntimeError:
                # a device failure (a kernel launch error from
                # kernels.ops, torch.OutOfMemoryError) does not replay the
                # live outcome, so the restore fails; WalCorruption and
                # NotImplementedError are RuntimeErrors and fail it too
                raise
            except Exception:
                # records land BEFORE the impl applies, so an op that
                # raised live (a dim-mismatched insert, an unhashable
                # key's TypeError) left exactly this record behind with
                # no state change — the deterministic impl raises the
                # same error here and the op stays skipped, as the
                # reference's replay skips it. The epoch-gap check on the
                # FOLLOWING records still fails loudly if the op had
                # actually applied live.
                continue
        self.attach(idx)
        return idx

    @staticmethod
    def _apply(idx, header: dict, arrays: dict) -> None:
        """Re-run one logged mutation through the SAME implementation path
        the live op took (the ``*_impl`` layer — below validation and
        below WAL logging, so replay never re-logs)."""
        op, meta = header["op"], header["meta"]
        if op == "insert":
            idx._insert_impl(meta["key"], arrays["vec"])
        elif op == "bulk_insert":
            idx._bulk_insert_impl(list(meta["keys"]), arrays["vec"])
        elif op == "update":
            idx._update_impl(meta["key"], arrays["vec"])
        elif op == "delete":
            idx._delete_impl(meta["key"])
        elif op.startswith("derived."):
            # trained state logged at query time (IVF's centroids); it
            # bumps no epoch
            idx._apply_derived(op, meta, arrays)
        else:
            raise WalCorruption(f"unknown WAL op {op!r}")

    # --------------------------------------------------------- compaction
    def compact(self, index) -> None:
        """Secure-delete compaction: physically rewrite the store so
        tombstoned vectors exist in NO file underneath it.

        1. ``index.compact()`` drops dead rows from the in-memory index
           (HNSW rebuilds its graph over live rows) and bumps the epoch —
           epoch-keyed caches over this index invalidate themselves.
        2. A fresh snapshot of the compacted state is published
           (``on_compact``, which ``index.compact()`` itself triggers on
           an attached index — calling either entry point is safe).
        3. The WAL is truncated (old records held the deleted vectors'
           insert payloads) and EVERY other snapshot is purged.

        If the process dies mid-way the store stays consistent (restore
        uses whatever snapshot is newest + the WAL), but files written
        before the crash may still hold deleted bytes — compaction only
        guarantees physical erasure once it returns."""
        if index._store is not self:
            self.attach(index)
        index.compact()                       # template -> on_compact(self)

    def on_compact(self, index) -> None:
        """Post-compaction hook invoked by ``VectorIndex.compact`` on an
        attached index: compaction is not WAL-logged (its epoch bumps
        would otherwise be an unreplayable gap), so the compacted state
        must become durable HERE, atomically with the old files' purge."""
        self.snapshot(index)                  # fresh epoch: writes + resets
        keep = f"{SNAP_PREFIX}{index.mutation_epoch:012d}"
        for d in os.listdir(self.root):
            if d.startswith(SNAP_PREFIX) and d != keep:
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
