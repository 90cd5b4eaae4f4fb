"""Logical-axis sharding, ported from ``repro/distributed/sharding.py`` as
a one-process analogue.

One rules table maps model-semantic axis names to mesh axes, as in the
reference: ``DEFAULT_RULES``, ``axis_rules``, ``current_mesh``,
``spec_for`` (the per-dim tuple the reference's ``PartitionSpec`` holds),
``param_sharding`` and ``bytes_per_device`` follow it rule for rule.

The mesh is the port's own. One process holds one tensor a device, as
the sharded index of ``core/sharded.py`` does, so a ``Mesh`` is axis
names, a shape and a grid of ``torch.device``s (by default the cards, or
``cuda:0`` repeated when there are fewer cards than the mesh needs).
``device_put(x, named_sharding(shape, *axes))`` splits ``x`` into its
blocks by ``spec_for`` and puts each block on its mesh coordinate's
device: a ``ShardedTensor`` whose ``addressable_shards`` (``.device``,
``.index``, ``.data``) are the analogue of a ``jax.Array``'s, one a mesh
coordinate in the mesh's order, replicas included.

``shard(x, *axes)`` returns ``x``: the reference pins layouts inside its
jit'd model code with ``with_sharding_constraint``, and a one-process
tensor has no layout to constrain (ROADMAP §3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device

# ---------------------------------------------------------------------------
# Default logical rules.  Values: mesh axis name, tuple of axis names, or None.
# ---------------------------------------------------------------------------
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "kv_seq": "model",        # decode-time KV cache sequence split (flash-decode)
    "qkv_embed": "model",
    # LM params (Megatron column->row)
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "layers": None,
    # MoE
    "dp_group": ("pod", "data"),
    "expert": "model",
    "expert_mlp": None,
    "capacity": "data",
    "tokens": ("pod", "data"),
    # recsys
    "table_rows": "model",
    "feature_dim": None,
    "fields": None,
    # gnn
    "edges": ("pod", "data"),
    "nodes": "model",
    "node_feat": None,
    # retrieval (the paper's workload)
    "db_rows": ("pod", "data", "model"),
    "db_dim": None,
    "queries": ("pod", "data"),
    # optimizer
    "zero": "data",
}


class Mesh:
    """Named mesh axes over a grid of ``torch.device``s.

    ``Mesh((2, 4), ("data", "model"))`` puts coordinate (i, j) on card
    ``4 i + j`` when the machine has 8 cards, else every coordinate on
    ``cuda:0``; ``device=`` puts them all on that device (``"cpu"``
    for the CPU). Without a card the default raises, as every entry
    point of the port does. ``shape`` maps each axis name to its size,
    as a ``jax.sharding.Mesh``'s."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        n = math.prod(shape)
        dev = resolve_device(device)
        if device is None and torch.cuda.device_count() >= n:
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [dev] * n
        grid = np.empty(n, dtype=object)
        grid[:] = devs
        self.devices = grid.reshape(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = n

    def coords(self) -> list[tuple[int, ...]]:
        """Every mesh coordinate, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Mesh | None = None
        self.rules: dict[str, Any] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh: Mesh | None, rules: dict[str, Any] | None = None):
    """Activate a mesh + logical rules for code run inside the block."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def current_mesh() -> Mesh | None:
    return _CTX.mesh


def _mesh_axes_for(logical: str | None, mesh: Mesh) -> tuple[str, ...]:
    if logical is None:
        return ()
    rule = _CTX.rules.get(logical, None)
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in mesh.axis_names)


def spec_for(shape: Sequence[int], logical_axes: Sequence[str | None]
             ) -> tuple:
    """The partition spec for ``shape`` given per-dim logical axis names:
    one entry a dim, a mesh axis name, a tuple of them, or None; () with
    no mesh.

    Drops mesh axes that do not evenly divide the corresponding dim, and
    never assigns the same mesh axis to two dims (first dim wins).
    """
    mesh = _CTX.mesh
    if mesh is None:
        return ()
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    used: set[str] = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        axes = [a for a in _mesh_axes_for(logical, mesh) if a not in used]
        # keep the largest prefix of axes whose product divides dim
        keep: list[str] = []
        prod = 1
        for a in axes:
            if dim % (prod * mesh.shape[a]) == 0:
                keep.append(a)
                prod *= mesh.shape[a]
        used.update(keep)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """The reference's layout constraint by logical axis names: ``x``
    itself (one process holds the whole tensor; module docstring)."""
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (``spec_for``'s tuple)."""

    mesh: Mesh
    spec: tuple


def named_sharding(shape: Sequence[int], *logical_axes: str | None
                   ) -> NamedSharding | None:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(shape, logical_axes))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(a, (str, type(None))) for a in x)


def _map_axes(fn, axes, *rest):
    """``fn(axes, *leaves)`` over a tree of logical-axes tuples (nested
    dicts, lists and NamedTuples) and trees of the same structure."""
    if _is_axes(axes):
        return fn(axes, *rest)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes.items()}
    children = [_map_axes(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(axes)]
    return type(axes)(*children) if hasattr(axes, "_fields") else children


def param_sharding(tree_axes, tree_shapes) -> Any:
    """Map a tree of logical-axes tuples + shapes to ``NamedSharding``s."""
    return _map_axes(lambda axes, shp: named_sharding(shp, *axes),
                     tree_axes, tree_shapes)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def bytes_per_device(shape: Sequence[int], spec: tuple, mesh: Mesh,
                     itemsize: int) -> int:
    per = int(np.prod(shape)) * itemsize
    for entry in spec:
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        for a in axes:
            per //= mesh.shape[a]
    return per


# ---------------------------------------------------------------------------
# Placement: a tensor split into its blocks, one a mesh coordinate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Shard:
    """One mesh coordinate's block: ``index`` (a slice a dim) into the
    whole tensor, ``data`` on ``device``."""

    device: torch.device
    index: tuple[slice, ...]
    data: torch.Tensor


@dataclasses.dataclass
class ShardedTensor:
    """A tensor placed on a mesh: its shape, dtype, sharding and every
    coordinate's ``Shard``, in the mesh's row-major order."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    addressable_shards: list[Shard]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the first shard's),
        joined from its blocks."""
        dev = torch.device(device) if device is not None else \
            self.addressable_shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for s in self.addressable_shards:
            key = tuple((i.start, i.stop) for i in s.index)
            if key not in done:
                out[s.index] = s.data.to(dev)
                done.add(key)
        return out


def block_index(shape: Sequence[int], spec: tuple, mesh: Mesh,
                coord: tuple[int, ...]) -> tuple[slice, ...]:
    """The block of ``shape`` that mesh coordinate ``coord`` holds under
    ``spec``: a dim split over mesh axes (a, b, ...) is cut into
    size(a) · size(b) · ... blocks, ``a`` the major one."""
    pos = dict(zip(mesh.axis_names, coord))
    index = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        block, count = 0, 1
        for a in axes:
            block = block * mesh.shape[a] + pos[a]
            count *= mesh.shape[a]
        size = dim // count
        index.append(slice(block * size, (block + 1) * size))
    return tuple(index)


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a tensor or an array) split by ``sharding``'s spec, each
    coordinate's block copied onto its device (``jax.device_put``)."""
    x = torch.as_tensor(x)
    mesh, spec = sharding.mesh, sharding.spec
    shards = []
    for coord in mesh.coords():
        index = block_index(x.shape, spec, mesh, coord)
        dev = mesh.devices[coord]
        blk = x[index]
        data = torch.empty(blk.shape, dtype=x.dtype, device=dev)
        data.copy_(blk, non_blocking=True)
        shards.append(Shard(dev, index, data))
    return ShardedTensor(tuple(x.shape), x.dtype, sharding, shards)
