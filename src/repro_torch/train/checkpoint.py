"""Checkpointing, ported from ``repro/train/checkpoint.py``: atomic,
versioned, keep-last-k, async-capable, and mesh-elastic (a checkpoint
saved on one mesh restores onto any other).

Format, as the reference's: one ``step_%08d.npz`` a step holding the
flattened state (path-keyed), plus a ``__meta__`` member, the JSON
``{"step": N, **meta}`` as uint8 bytes; written to ``<path>.tmp.npz``
and published with ``os.replace``. A leaf's key is its path joined by
"/": dict keys (in sorted order, as JAX flattens them), list indices and
NamedTuple field names (``OptState`` gives ``opt/m/...`` and
``opt/step``); an ``nn.Module`` contributes its dotted parameter names
(an ``LM``'s ``params/layers.0.wq.weight``). A tree of plain nested
dicts and lists of fp32 tensors writes the reference's members exactly.
numpy has no bfloat16: a bf16 leaf is stored as its raw bits in a
2-byte void array, which is what the reference's ``np.asarray`` of a
bf16 leaf writes, and its dtype is named in the meta (``"dtypes"``).

The snapshot is taken on the caller's thread: each leaf is copied to the
host before ``save`` returns (the port's train step updates the
parameters and the optimizer state in place, so an async writer must
never read the live tensors). ``restore`` reads each leaf's bytes
straight from the file (``np.savez`` stores them uncompressed), a few
leaves at once on worker threads, checks each against the zip's CRC-32
as ``np.load`` does, and returns a tree of the template's structure (a
module rebuilt around the restored tensors) on the template leaves'
devices, or ``device``; with ``inplace=True`` it copies into the template's own
tensors, so a resume holds one copy of the state. Checkpoints store
logical content only: ``restore_sharded`` places each leaf on any mesh
by its logical axes.
"""
from __future__ import annotations

import copy
import json
import os
import re
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    ShardedTensor,
    _is_axes,
    axis_rules,
    device_put,
    named_sharding,
)
from repro_torch.utils import PyTree, logger

_SEP = "/"
_RAW16 = np.dtype("V2")              # what numpy writes for a bf16 leaf
_CHUNK = 64 << 20                    # a member is read in pieces of this
_READERS = 4                         # leaves read and checked at once


def _children(tree) -> Iterator[tuple[str, object]]:
    """A node's (key, child) pairs, or none for a leaf: dict keys
    sorted, list and tuple indices, NamedTuple fields, a module's named
    parameters."""
    if isinstance(tree, torch.nn.Module):
        return iter(tree.named_parameters())
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return iter(())


def _is_node(tree) -> bool:
    return isinstance(tree, (torch.nn.Module, dict, list, tuple))


def tree_leaves(tree, prefix: str = "", is_leaf=None
                ) -> list[tuple[str, object]]:
    """(key, leaf) for every leaf of ``tree``, keys "/"-joined; a node
    for which ``is_leaf`` holds counts as a leaf."""
    if not _is_node(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix[:-1], tree)]
    return [kv for k, v in _children(tree)
            for kv in tree_leaves(v, f"{prefix}{k}{_SEP}", is_leaf)]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else holds: a bf16 tensor as
    its raw bits (``_RAW16``)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _flatten(tree: PyTree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """-> ({key: host copy}, {key: dtype name} of the bf16 leaves)."""
    flat, dtypes = {}, {}
    for key, leaf in tree_leaves(tree):
        flat[key] = _host(leaf)
        if flat[key].dtype == _RAW16:
            dtypes[key] = "bfloat16"
    return flat, dtypes


def _tensor(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    if arr.dtype == _RAW16:                      # raw 16-bit (bf16) bits
        return torch.from_numpy(arr.view(np.int16)).view(
            getattr(torch, dtype_name or "bfloat16"))
    return torch.from_numpy(arr)


def _unflatten(template: PyTree, read, *, device=None, inplace=False,
               prefix: str = "") -> PyTree:
    """The template's structure with each leaf read by ``read(key)``, in
    ``tree_leaves``' order: new tensors on the template leaf's device (or
    ``device``), a module rebuilt around them; or, ``inplace``, copied
    into the template's own tensors."""
    if isinstance(template, torch.nn.Module):
        new = {}
        for name, p in template.named_parameters():
            t = read(prefix + name)
            if inplace:
                with torch.no_grad():
                    p.copy_(t)
            else:
                new[id(p)] = torch.nn.Parameter(
                    t.to(device or p.device), requires_grad=p.requires_grad)
        return template if inplace else copy.deepcopy(template, new)
    if _is_node(template):
        kids = {k: _unflatten(v, read, device=device, inplace=inplace,
                              prefix=f"{prefix}{k}{_SEP}")
                for k, v in _children(template)}
        if isinstance(template, dict):
            return {k: kids[str(k)] for k in template}
        vals = [kids[str(i)] for i in range(len(template))] \
            if not hasattr(template, "_fields") else \
            [kids[f] for f in template._fields]
        return type(template)(*vals) if hasattr(template, "_fields") \
            else type(template)(vals)
    t = read(prefix[:-1])
    if isinstance(template, torch.Tensor):
        if inplace:
            with torch.no_grad():
                template.copy_(t)
            return template
        return t.to(device or template.device)
    return t


class _Member(NamedTuple):
    """A ``.npy`` member of an ``.npz``: where its data starts in the
    file, its dtype and shape, the CRC-32 of its ``.npy`` header, and
    the zip's CRC-32 of the whole member (header and data)."""
    offset: int
    dtype: np.dtype
    shape: tuple
    head_crc: int
    crc: int


def _stored_members(path: str) -> dict[str, _Member]:
    """Every member of an ``.npz`` by name (``.npy`` dropped). ``np.savez``
    stores its members uncompressed and C-ordered, so a member's data is
    one run of bytes in the file; a member that is not raises
    ``ValueError``."""
    headers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            name = info.filename
            if info.compress_type != zipfile.ZIP_STORED or \
                    not name.endswith(".npy"):
                raise ValueError(f"checkpoint member {name!r} is not a "
                                 "stored .npy (np.savez writes only those)")
            f.seek(info.header_offset)
            local = f.read(30)                  # the local file header
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + name_len + extra_len
            f.seek(start)
            version = np.lib.format.read_magic(f)
            if version not in headers:
                raise ValueError(f"checkpoint member {name!r}: .npy "
                                 f"version {version} is not read")
            shape, fortran, dtype = headers[version](f)
            if fortran or dtype.hasobject:
                raise ValueError(f"checkpoint member {name!r} is "
                                 "Fortran-ordered or holds objects")
            offset = f.tell()
            f.seek(start)
            out[name[:-4]] = _Member(offset, dtype, shape,
                                     zlib.crc32(f.read(offset - start)),
                                     info.CRC)
    return out


def _read_member(path: str, key: str, m: _Member) -> np.ndarray:
    """A member's data, read from its offset in ``_CHUNK`` pieces, each
    folded into the CRC-32 as it lands; ``ValueError`` if the file is
    short or the CRC differs from the zip's (the check ``np.load`` makes)."""
    arr = np.empty(m.shape, m.dtype)
    buf = memoryview(arr.reshape(-1).view(np.uint8))
    crc = m.head_crc
    with open(path, "rb", buffering=0) as f:
        f.seek(m.offset)
        for i in range(0, len(buf), _CHUNK):
            piece = buf[i:i + _CHUNK]
            if f.readinto(piece) != len(piece):
                raise ValueError(f"checkpoint leaf {key!r} is short")
            crc = zlib.crc32(piece, crc)
    if crc != m.crc:
        raise ValueError(f"checkpoint leaf {key!r} fails its CRC-32 check")
    return arr


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        # the last save: the caller's stall, the write's seconds and the
        # file's bytes (written when the write ends)
        self.last_save: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: PyTree, meta: dict | None = None) -> str:
        self.wait()
        t0 = time.perf_counter()
        flat, dtypes = _flatten(state)   # snapshot on caller thread
        meta = dict(meta or {})
        if dtypes:
            meta["dtypes"] = dtypes
        self.last_save = {"step": step, "stall_s": time.perf_counter() - t0}
        if self.async_save:
            t = threading.Thread(target=self._write_guarded,
                                 args=(step, flat, meta))
            t.start()
            self._pending = t
            return self._path(step)
        return self._write(step, flat, meta)

    def _write_guarded(self, step: int, flat: dict, meta: dict) -> None:
        try:
            self._write(step, flat, meta)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: dict, meta: dict | None) -> str:
        t0 = time.perf_counter()
        path = self._path(step)
        tmp = path + ".tmp.npz"
        payload = dict(flat)
        payload["__meta__"] = np.frombuffer(
            json.dumps({"step": step, **(meta or {})}).encode(), dtype=np.uint8)
        np.savez(tmp[:-4], **payload)
        os.replace(tmp, path)           # atomic publish
        self._gc()
        self.last_save.update(write_s=time.perf_counter() - t0,
                              bytes=os.path.getsize(path))
        logger.info(f"checkpoint saved: {path}")
        return path

    def wait(self):
        """Wait for the pending async write; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: int | None = None, *,
                device=None, inplace: bool = False) -> tuple[PyTree, dict]:
        """-> (the state of ``step`` (default the newest) in the
        template's structure, its meta). Raises ``KeyError`` for a leaf
        the file lacks and ``ValueError`` for a shape that differs from
        the template's, both before any leaf is read, and ``ValueError``
        for a leaf whose bytes fail the zip's CRC-32 (``inplace``: the
        leaves before it have been copied already)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        members = _stored_members(path)
        meta = json.loads(_read_member(path, "__meta__", members["__meta__"])
                          .tobytes().decode())
        dtypes = meta.get("dtypes", {})
        keys = []
        for key, leaf in tree_leaves(template):
            if key not in members or key == "__meta__":
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if tuple(members[key].shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {members[key].shape} "
                    f"vs template {tuple(leaf.shape)}")
            keys.append(key)
        # _READERS leaves are read and checked ahead of the one being
        # placed (the file reads and CRC-32s release the GIL)
        with ThreadPoolExecutor(_READERS) as pool:
            ahead = {}
            todo = iter(keys)

            def submit_next():
                key = next(todo, None)
                if key is not None:
                    ahead[key] = pool.submit(_read_member, path, key,
                                             members[key])

            for _ in range(_READERS):
                submit_next()

            def read(key):
                arr = ahead.pop(key).result()
                submit_next()
                return _tensor(arr, dtypes.get(key))

            tree = _unflatten(template, read, device=device, inplace=inplace)
        return tree, meta

    def restore_sharded(self, template: PyTree, axes: PyTree, mesh,
                        step: int | None = None) -> tuple[PyTree, dict]:
        """Elastic restore: place each leaf onto ``mesh`` by its logical
        axes -> the template's structure with ``ShardedTensor`` leaves (a
        module as the dict of its named parameters). ``axes`` mirrors the
        template, keyed as ``models.common.named_tensors`` below a module
        or a model's ``*_param_axes``. The mesh may differ arbitrarily from
        the one that saved (ZeRO shards, TP degree, pod count) because
        only logical content was stored."""
        host, meta = self.restore(template, step, device="cpu")
        by_name = {k.replace(_SEP, "."): v
                   for k, v in tree_leaves(axes, is_leaf=_is_axes)}
        with axis_rules(mesh):
            def place(key, t):
                ax = by_name[key.replace(_SEP, ".")]
                return device_put(t, named_sharding(t.shape, *ax))
            placed = _map_leaves(place, host)
        return placed, meta


def _map_leaves(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over a tree, a module becoming the dict of its
    named parameters."""
    if isinstance(tree, torch.nn.Module):
        return {n: fn(prefix + n, p.detach())
                for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}{k}{_SEP}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map_leaves(fn, v, f"{prefix}{k}{_SEP}")
                for k, v in _children(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else vals
    return fn(prefix[:-1], tree)
