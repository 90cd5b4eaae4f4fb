"""Write-ahead mutation log, ported from ``repro/store/wal.py`` (numpy
in both packages: for the same operations both write the same bytes).

Every ``insert``/``update``/``delete``/``bulk_insert`` against a
store-attached ``VectorIndex`` appends one record here *before* the
mutation touches index state, so a crash between snapshots replays the
tail exactly — MeMemo persists every mutation to IndexedDB before
acknowledging it; this file is that durability contract. Each append is
flushed to the OS (process-crash durability); it is not fsynced.

File layout (binary, append-only):

    RWAL\\x01                                  file magic + format version
    [u32 payload_len][u32 crc32][payload]      one frame per record
    ...

A record payload is a JSON header line (op, epoch-before-apply, op
metadata, array specs) followed by the raw bytes of its arrays in spec
order — vectors travel uncompressed, which is what makes the
secure-delete byte-absence property testable against this file. The
header's ``epoch`` is the index's ``mutation_epoch`` *before*
the op applied: replay skips records already covered by a snapshot by
comparing it with the restored epoch.

Torn tails: a crash mid-append leaves a frame with a short payload or a
CRC mismatch. Readers stop at the first bad frame (everything before it
is intact by construction); ``repair()`` truncates the file back to the
last valid frame so the log can keep growing after a crash.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator

import numpy as np

FILE_MAGIC = b"RWAL\x01"            # 4 magic bytes + 1 format-version byte
_FRAME = struct.Struct("<II")       # payload_len, crc32(payload)


class WalCorruption(RuntimeError):
    """Structural damage the reader cannot safely skip (bad file magic,
    unknown op). Torn tails are NOT corruption — they are expected crash
    debris and handled by ``repair()``."""


class WriteAheadLog:
    def __init__(self, path: str):
        self.path = path
        self._fh = None             # lazily-opened append handle

    # ------------------------------------------------------------- append
    def _open_append(self):
        if self._fh is None:
            fresh = (not os.path.exists(self.path)
                     or os.path.getsize(self.path) == 0)
            self._fh = open(self.path, "ab")
            if fresh:
                self._fh.write(FILE_MAGIC)
                self._fh.flush()
        return self._fh

    @staticmethod
    def encode(op: str, epoch: int, meta: dict | None,
               arrays: dict | None) -> bytes:
        specs, blobs = [], []
        for name, arr in (arrays or {}).items():
            a = np.ascontiguousarray(arr)
            specs.append({"name": name, "dtype": str(a.dtype),
                          "shape": list(a.shape)})
            blobs.append(a.tobytes())
        header = {"op": op, "epoch": int(epoch), "meta": meta or {},
                  "arrays": specs}
        # json escapes control characters, so the header line contains no
        # raw newline and the b"\n" separator below is unambiguous
        return json.dumps(header).encode() + b"\n" + b"".join(blobs)

    def append(self, op: str, *, epoch: int, meta: dict | None = None,
               arrays: dict | None = None) -> None:
        """Durably append one record. Called BEFORE the mutation applies."""
        payload = self.encode(op, epoch, meta, arrays)
        fh = self._open_append()
        fh.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
        fh.write(payload)
        fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -------------------------------------------------------------- read
    @staticmethod
    def _decode(payload: bytes) -> tuple[dict, dict[str, np.ndarray]]:
        nl = payload.index(b"\n")
        header = json.loads(payload[:nl].decode())
        arrays: dict[str, np.ndarray] = {}
        off = nl + 1
        for spec in header["arrays"]:
            dt = np.dtype(spec["dtype"])
            n = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
            arrays[spec["name"]] = np.frombuffer(
                payload[off:off + n], dtype=dt).reshape(spec["shape"]).copy()
            off += n
        return header, arrays

    def _scan(self) -> Iterator[tuple[dict, dict, int]]:
        """Yield (header, arrays, end_offset) for every intact frame,
        stopping silently at the first torn one."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            head = f.read(len(FILE_MAGIC))
            if len(head) < len(FILE_MAGIC):
                return                      # torn first write: no records
            if head != FILE_MAGIC:
                raise WalCorruption(
                    f"{self.path}: bad WAL magic {head!r}")
            off = len(FILE_MAGIC)
            while True:
                frame = f.read(_FRAME.size)
                if len(frame) < _FRAME.size:
                    return                  # clean EOF or torn frame header
                plen, crc = _FRAME.unpack(frame)
                payload = f.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    return                  # torn / damaged tail record
                header, arrays = self._decode(payload)
                off += _FRAME.size + plen
                yield header, arrays, off

    def records(self) -> Iterator[tuple[dict, dict[str, np.ndarray]]]:
        """Replay iterator over intact records, oldest first."""
        for header, arrays, _ in self._scan():
            yield header, arrays

    def valid_length(self) -> int:
        """Byte offset just past the last intact frame."""
        if not os.path.exists(self.path):
            return 0
        off = (len(FILE_MAGIC)
               if os.path.getsize(self.path) >= len(FILE_MAGIC) else 0)
        for _, _, end in self._scan():
            off = end
        return off

    # ------------------------------------------------------------ repair
    def repair(self) -> bool:
        """Truncate a torn tail left by a crash mid-append. Returns True
        if any bytes were cut. Safe to call on a healthy log (no-op)."""
        if not os.path.exists(self.path):
            return False
        self.close()
        good = self.valid_length()
        if good < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(good)
            return True
        return False

    def reset(self) -> None:
        """Empty the log (after a snapshot made its records redundant, or
        during compaction). Truncation removes the old record bytes from
        the file — part of the secure-delete story."""
        self.close()
        with open(self.path, "wb") as f:
            f.write(FILE_MAGIC)
            f.flush()

    @property
    def size_bytes(self) -> int:
        return os.path.getsize(self.path) if os.path.exists(self.path) else 0
