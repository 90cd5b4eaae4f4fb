"""AdamW with global-norm clipping and LR schedules, ported from
``repro/train/optimizer.py`` (no ``torch.optim``: its AdamW decays the
weights before the step, the reference adds the decay to the step).

State mirrors the parameter tree by name (``models.common.named_tensors``:
an ``LM``'s ``state_dict`` keys, the dotted paths of a dict tree):
``OptState(m, v, step)`` with fp32 ``m`` and ``v`` and an int32 step on
the parameters' device. ``adamw_update`` follows the reference's
arithmetic in its order and writes the parameters, ``m`` and ``v`` in
place (the port's analogue of the reference's donated buffers). The
schedules return fp32 scalars on the step's device, and every division
is by a tensor, so the card divides as the CPU does (PyTorch on the card
turns a division by a Python scalar into a product with its reciprocal).

``opt_state_axes`` gives m and v the parameters' logical axes with
``layers`` -> ``zero`` (ZeRO-1), keyed as the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.common import named_tensors
from repro_torch.models.transformer import LM
from repro_torch.utils import PyTree, tree_norm


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable:
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / step.new_tensor(float(max(warmup_steps, 1)))
        t = torch.clamp((step - warmup_steps) / step.new_tensor(
            float(max(total_steps - warmup_steps, 1))), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant_lr(lr: float) -> Callable:
    return lambda step: _f32(step).new_tensor(lr)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def lr_at(self, step) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else \
            _f32(step).new_tensor(self.lr)


class OptState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: torch.Tensor


def adamw_init(params: PyTree) -> OptState:
    named = named_tensors(params)
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in named}
    return OptState(m=m, v={n: t.clone() for n, t in m.items()},
                    step=torch.zeros((), dtype=torch.int32,
                                     device=named[0][1].device))


def reference_rank(params: PyTree) -> dict[str, int]:
    """Each leaf's rank in the reference's layout, by name. The reference
    stacks an LM's per-layer weights along a leading [L] axis, so a leaf
    of ``LM.layers`` has one axis more there than here (a layer's
    ``attn_norm`` is [D] here, [L, D] there); the encoder (stacked in
    both), the recsys and the GraphSAGE trees have the reference's
    shapes."""
    stacked = isinstance(params, LM)
    return {n: p.dim() + int(stacked and n.startswith("layers."))
            for n, p in named_tensors(params)}


def decayed(params: PyTree) -> dict[str, bool]:
    """Which leaves weight decay applies to: the reference decays a leaf
    of rank >= 2 in its own layout (no decay on norms and biases), so an
    LM's per-layer norms decay and its ``final_norm`` does not."""
    return {n: r >= 2 for n, r in reference_rank(params).items()}


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    g_norm = tree_norm(grads)
    scale = torch.clamp(g_norm.new_tensor(max_norm)
                        / torch.clamp_min(g_norm, 1e-12), max=1.0)
    return {n: g * scale for n, g in grads.items()}, g_norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: PyTree,
                 grads: dict[str, torch.Tensor], state: OptState
                 ) -> tuple[PyTree, OptState, dict]:
    """One AdamW step: the grads (by leaf name) widened to fp32 and
    clipped by their global norm, then per leaf m, v, the bias-corrected
    ``delta = mh / (sqrt(vh) + eps)``, ``+ wd * p`` on the decayed
    leaves, ``p - lr * delta`` cast back to p's dtype. Updates the
    parameters and the state in place; returns them and {grad_norm,
    lr}."""
    grads = {n: g.float() for n, g in grads.items()}
    if cfg.grad_clip > 0:
        grads, g_norm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        g_norm = tree_norm(grads)
    step = state.step + 1
    lr = cfg.lr_at(step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    decay = decayed(params) if cfg.weight_decay > 0 else {}
    for n, p in named_tensors(params):
        g, m, v = grads[n], state.m[n], state.v[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay.get(n):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(state.m, state.v, step), {"grad_norm": g_norm,
                                                      "lr": lr}


def opt_state_axes(param_axes: dict[str, tuple]) -> Any:
    """Logical axes for (m, v): param axes with 'layers' -> 'zero' (ZeRO-1:
    the stacked-layer dim shards across the data axis). ``param_axes`` is
    a model's ``*_param_axes`` (keyed as ``named_tensors``); an ``LM``'s
    leaves have no stacked dim here (``lm_param_axes``)."""
    mapped = {n: tuple("zero" if a == "layers" else a for a in axes)
              for n, axes in param_axes.items()}
    return OptState(m=mapped, v=mapped, step=())
