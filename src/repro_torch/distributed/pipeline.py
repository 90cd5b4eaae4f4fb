"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis,
ported from ``repro/distributed/pipeline.py`` as a one-process analogue.

Stage s's slice of the stacked parameters goes on the device at
coordinate s along the pipeline axis (the other axes at 0). The
schedule is the reference's lock-step GPipe wavefront:
``n_micro + n_stages - 1`` ticks, and at tick t stage s computes
microbatch t - s. The reference runs every stage at every tick and masks
the bubbles; here one process launches each tick's valid (stage,
microbatch) pairs, stage 0 first, and an activation hops to the next
stage's device with ``Tensor.to(next_device, non_blocking=True)`` (a
no-op between stages that share a card). The stages of one tick run
concurrently where they sit on different cards, since every launch is
queued on its own card.

The result stays differentiable through autograd (the reference's is
under ``jax.grad``): gradients flow back through the hops into the
stacked parameters.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.common import tree_map


def pipeline_schedule(n_stages: int, n_micro: int
                      ) -> list[list[tuple[int, int]]]:
    """The GPipe wavefront: for each of the ``n_micro + n_stages - 1``
    ticks, the (stage, microbatch) pairs it computes."""
    return [[(s, t - s) for s in range(n_stages) if 0 <= t - s < n_micro]
            for t in range(n_micro + n_stages - 1)]


def stage_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The device of each stage: coordinate s along ``axis``, 0 along
    the mesh's other axes."""
    a = mesh.axis_names.index(axis)
    rank = len(mesh.axis_names)
    return [mesh.devices[tuple(s if i == a else 0 for i in range(rank))]
            for s in range(mesh.shape[axis])]


def pipeline_apply(mesh: Mesh, axis: str, stage_fn: Callable,
                   stage_params, x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``n_stages`` pipeline stages over ``n_micro`` microbatches.

    stage_fn(params_slice, x) -> y        (same shape as x)
    stage_params: tree with leading dim n_stages (stage s's slice on
      stage s's device)
    x_micro: [n_micro, mb, ...]
    returns [n_micro, mb, ...] — the last stage's outputs, on
    ``x_micro``'s device.
    """
    devs = stage_devices(mesh, axis)
    n_stages, n_micro = len(devs), x_micro.shape[0]

    def stage_slice(s):
        def take(a):
            if a.shape[0] != n_stages:
                raise ValueError(f"stage_params lead with {a.shape[0]}, "
                                 f"the mesh's {axis!r} has {n_stages}")
            return a[s].to(devs[s], non_blocking=True)
        return tree_map(take, stage_params)

    params = [stage_slice(s) for s in range(n_stages)]
    held: list[torch.Tensor | None] = [None] * n_stages
    outputs: list[torch.Tensor | None] = [None] * n_micro
    for tick in pipeline_schedule(n_stages, n_micro):
        sent: dict[int, torch.Tensor] = {}
        for s, m in tick:
            x = (x_micro[m].to(devs[0], non_blocking=True) if s == 0
                 else held[s])
            y = stage_fn(params[s], x)
            if s == n_stages - 1:
                outputs[m] = y.to(x_micro.device, non_blocking=True)
            else:                                  # the hop to stage s + 1
                sent[s + 1] = y.to(devs[s + 1], non_blocking=True)
        held = [sent.get(s) for s in range(n_stages)]
    return torch.stack(outputs)


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
