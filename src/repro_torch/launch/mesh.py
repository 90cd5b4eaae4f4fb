"""Mesh construction for the dry run and the card cells, ported from
``repro/launch/mesh.py`` on the port's ``distributed/sharding.py:Mesh``.

These are logical layouts: a ``Mesh`` is axis names, a shape and a grid
of ``torch.device``s, and ``launch/steps.py`` reads its axes (through
the logical-axis rules) and its size. Axis semantics:

  pod    -- data parallelism across groups of devices; only gradient
            all-reduces travel this axis.
  data   -- data parallelism (batch sharding, ZeRO-1 state shards, GNN
            edge parallelism, MoE token sharding).
  model  -- tensor/expert/table parallelism (Megatron TP, MoE EP, recsys
            embedding-row sharding, retrieval DB sharding, decode KV
            sequence splits).

Meshes are built by functions, never at import time.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``; every coordinate on
    ``meta``, so it needs no card and touches no device state."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device="meta")


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small ("data", "model") mesh over the cards that exist (the
    reference's clamping to the device count); ``device=`` puts every
    coordinate on that device ("cpu" for the tests)."""
    n = max(torch.cuda.device_count(), 1) if device is None else 1
    data = min(data, n)
    model = max(1, min(model, n // data))
    return Mesh((data, model), ("data", "model"), device=device)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes over which the global batch is sharded (DP axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None


def dp_size(mesh: Mesh) -> int:
    s = 1
    for a in batch_axes(mesh):
        s *= mesh.shape[a]
    return s


def tp_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)
