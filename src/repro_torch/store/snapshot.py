"""Chunked, versioned index snapshots, ported from
``repro/store/snapshot.py``: the same page arrays and the same
``manifest.json`` bytes as the reference for the same state (the zip
members of a page carry timestamps, so whole ``.npz`` files differ).

One snapshot is a directory of uncompressed npz *pages* plus a JSON
manifest — the on-disk image of a backend's ``state_dict()``:

    snap_000000000042/
      manifest.json              format_version, kind, config, epoch,
                                 meta (keys/rng/…), array -> page table
      vectors.00000.npz          pages: rows [0, rows_per_page) of axis 0
      vectors.00001.npz          ...
      deleted.00000.npz

Pages are chunked along axis 0 at a byte budget (``page_bytes``) — the
analog of MeMemo writing IndexedDB rows in bounded batches (paper C3) —
so a multi-GB index never needs a single monolithic file and restore can
stream page by page. ``np.savez`` without compression stores the raw
array bytes, which keeps the secure-delete byte-absence test honest: a
compacted store must not contain a deleted vector's bytes anywhere, and
raw pages make that property directly checkable.

Atomicity: everything is written into ``<dir>.tmp`` (manifest last),
then a single ``os.rename`` publishes the snapshot. A crash mid-write leaves only a ``*.tmp`` directory, which
readers ignore and the store garbage-collects.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"


def _rows_per_page(shape: tuple, itemsize: int, page_bytes: int) -> int:
    row_bytes = max(int(np.prod(shape[1:], dtype=np.int64)) * itemsize, 1)
    return max(1, page_bytes // row_bytes)


def write_snapshot(dir_path: str, *, kind: str, config: dict, epoch: int,
                   arrays: dict, meta: dict,
                   page_bytes: int = 4 << 20) -> str:
    """Write one snapshot atomically; ``dir_path`` must not exist yet."""
    tmp = dir_path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest_arrays: dict = {}
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        rows = _rows_per_page(a.shape, a.itemsize, page_bytes)
        n0 = a.shape[0]
        n_pages = max(-(-n0 // rows), 1)           # >= 1 page even when empty
        pages = []
        for p in range(n_pages):
            chunk = a[p * rows:(p + 1) * rows]
            fname = f"{name}.{p:05d}.npz"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.savez(f, data=chunk)            # uncompressed: raw bytes
            pages.append({"file": fname, "rows": int(chunk.shape[0])})
        manifest_arrays[name] = {"dtype": str(a.dtype),
                                 "shape": list(a.shape), "pages": pages}
    manifest = {"format_version": FORMAT_VERSION, "kind": kind,
                "config": config, "epoch": int(epoch), "meta": meta,
                "arrays": manifest_arrays}
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)                     # manifest last: commit point
    os.rename(tmp, dir_path)                       # atomic publish
    return dir_path


def read_snapshot(dir_path: str) -> tuple[dict, dict]:
    """Load a snapshot -> (manifest, arrays). Pages are concatenated back
    along axis 0 and validated against the manifest's shape/dtype."""
    with open(os.path.join(dir_path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"snapshot {dir_path} has format_version "
            f"{manifest['format_version']} > supported {FORMAT_VERSION}")
    arrays: dict = {}
    for name, spec in manifest["arrays"].items():
        parts = []
        for page in spec["pages"]:
            with np.load(os.path.join(dir_path, page["file"]),
                         allow_pickle=False) as z:
                parts.append(z["data"])
        a = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if list(a.shape) != spec["shape"] or str(a.dtype) != spec["dtype"]:
            raise ValueError(
                f"snapshot {dir_path}: array {name!r} pages reassemble to "
                f"{a.shape}/{a.dtype}, manifest says "
                f"{spec['shape']}/{spec['dtype']}")
        arrays[name] = a
    return manifest, arrays
