# Durable index store, ported from ``repro/store``: write-ahead log +
# chunked snapshots + secure-delete compaction, fronted by ``IndexStore``.
from repro_torch.store.snapshot import read_snapshot, write_snapshot
from repro_torch.store.store import IndexStore
from repro_torch.store.wal import WalCorruption, WriteAheadLog

__all__ = ["IndexStore", "WriteAheadLog", "WalCorruption",
           "read_snapshot", "write_snapshot"]
