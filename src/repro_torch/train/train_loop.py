"""The train step and the training loop, ported from
``repro/train/train_loop.py``.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients by autograd (the
reference's ``jax.value_and_grad``), optionally over microbatches whose
fp32 gradients are summed (the reference's row split and scan), then
``adamw_update``. The parameters and the optimizer state are updated in
place: that is the port's analogue of the reference's donated buffers,
and the step returns the same objects. The step enables the gradients of
the leaves it trains (``init_lm`` and the other initializers freeze
theirs for serving) and moves the batch's numpy arrays to the
parameters' device; it waits for nothing on the card (the metrics are
device tensors).

``fit`` is the reference's single-controller loop, a checkpoint every
``ckpt_every`` steps when given a ``CheckpointManager``
(``train/checkpoint.py``); the fault-tolerant wrapper is
``train/fault_tolerance.py:run_resilient``.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator

import torch

from repro_torch.models.common import named_tensors
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.utils import PyTree, logger


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1) -> Callable:
    """loss_fn(params, **batch) -> scalar loss."""

    def grads_of(leaves, loss):
        return torch.autograd.grad(loss, leaves, materialize_grads=True)

    def step(params: PyTree, opt_state: OptState, batch: dict):
        names, leaves = zip(*named_tensors(params))
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        batch = {k: _on(v, dev) for k, v in batch.items()}
        if microbatches <= 1:
            loss = loss_fn(params, **batch)
            grads = grads_of(leaves, loss)
            loss = loss.detach()
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])
            micro = {k: split(v) for k, v in batch.items()}
            loss = torch.zeros((), device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves]
            for i in range(microbatches):
                mb_loss = loss_fn(params, **{k: v[i] for k, v in
                                             micro.items()})
                for acc, g in zip(grads, grads_of(leaves, mb_loss)):
                    acc.add_(g.float())
                loss = loss + mb_loss.detach()
            n = torch.tensor(float(microbatches), device=dev)
            loss = loss / n
            grads = [g / n for g in grads]
        params, opt_state, om = adamw_update(
            opt_cfg, params, dict(zip(names, grads)), opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def init_train_state(params: PyTree) -> OptState:
    return adamw_init(params)


def fit(params: PyTree, train_step: Callable, batches: Iterator[dict], *,
        steps: int, ckpt=None, ckpt_every: int = 50, log_every: int = 10,
        opt_state: OptState | None = None, start_step: int = 0,
        on_step=None) -> tuple[PyTree, OptState, list[dict]]:
    """The reference's plain loop: ``steps - start_step`` train steps, a
    history of {step, loss, sec} (each step waited for through its
    loss); with ``ckpt``, {params, opt} saved after step i where
    (i + 1) % ckpt_every == 0, as step i + 1."""
    opt_state = opt_state if opt_state is not None else adamw_init(params)
    history = []
    for i in range(start_step, steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"step": i, "loss": loss, "sec": dt})
        if on_step is not None:
            on_step(i, params, opt_state, metrics)
        if log_every and i % log_every == 0:
            logger.info(f"step {i}: loss={loss:.4f} "
                        f"gnorm={float(metrics['grad_norm']):.3f} "
                        f"{dt*1e3:.0f}ms")
        if ckpt is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state})
    return params, opt_state, history
