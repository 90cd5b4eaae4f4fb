"""Fault tolerance, ported from ``repro/train/fault_tolerance.py``.

Mechanisms:

  * run_resilient — supervisor loop: any step failure (device loss,
    preemption, injected fault) triggers restore-from-latest-checkpoint and
    replay. The data pipeline is (seed, step)-deterministic, so replay is
    exact; with checkpoint-every-K the worst-case lost work is K steps.
  * StragglerWatchdog — rolling p95 step-time deadline; steps beyond
    ``factor * p95`` are flagged (at pod scale the action is re-scheduling
    the slow host's shard / firing the backup executor — here we record and
    expose them; the hook receives each event).
  * elastic re-mesh — checkpoints hold logical content only, so restore can
    target a *different* mesh via CheckpointManager.restore_sharded.

The port's train step updates the parameters and the optimizer state in
place, so the loop never reuses what a failed step touched: a restart
from scratch builds new tensors (and a new module) from a host snapshot
of ``init_params`` taken before the first step, and a restore builds new
ones from the checkpoint, once an async save still in flight has landed
(the reference looks for the newest file without waiting for it). A
step's time runs through ``float(loss)``, which waits for the step on
the card (the reference reads its clock before that wait; ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager, _flatten, \
    _tensor, _unflatten
from repro_torch.train.optimizer import OptState, adamw_init
from repro_torch.utils import PyTree, logger


class InjectedFailure(RuntimeError):
    """Stands in for a CUDA error or a device loss in tests."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    p95: float


class StragglerWatchdog:
    def __init__(self, window: int = 50, factor: float = 3.0,
                 min_samples: int = 10, on_straggler: Callable | None = None):
        self.times: list[float] = []
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self.events: list[StragglerEvent] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, seconds: float) -> bool:
        flagged = False
        if len(self.times) >= self.min_samples:
            p95 = float(np.percentile(self.times[-self.window:], 95))
            if seconds > self.factor * p95:
                ev = StragglerEvent(step, seconds, p95)
                self.events.append(ev)
                logger.info(f"straggler: step {step} took {seconds*1e3:.0f}ms "
                            f"(p95 {p95*1e3:.0f}ms)")
                if self.on_straggler:
                    self.on_straggler(ev)
                flagged = True
        self.times.append(seconds)
        return flagged


def run_resilient(init_params: PyTree, train_step: Callable,
                  batch_fn: Callable[[int], dict], *, steps: int,
                  ckpt: CheckpointManager, ckpt_every: int = 20,
                  max_restarts: int = 5, watchdog: StragglerWatchdog | None = None,
                  fail_at: Iterator[int] | None = None
                  ) -> tuple[PyTree, OptState, dict]:
    """Supervised training: restart from the newest checkpoint on failure.

    ``batch_fn(step)`` must be deterministic in ``step`` (see data/synthetic).
    ``fail_at`` injects failures at the given global steps (testing).
    ``init_params`` itself is never trained.
    """
    # host snapshot: every step updates its state in place, and a restart
    # from scratch must not see what the steps before it left there
    init_host, _ = _flatten(init_params)
    fresh = lambda: _unflatten(
        init_params, lambda key: _tensor(init_host[key], None).clone())
    params = fresh()
    opt_state = adamw_init(params)
    fail_steps = set(fail_at or [])
    restarts = 0
    losses = {}
    step = 0
    while step < steps:
        try:
            if step in fail_steps:
                fail_steps.discard(step)
                raise InjectedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = batch_fn(step)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            losses[step] = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.observe(step, dt)
            step += 1
            if ckpt_every and step % ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        except (InjectedFailure, RuntimeError) as e:  # device loss, preemption
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts") from e
            ckpt.wait()                 # an async save in flight lands first
            latest = ckpt.latest_step()
            if latest is None:
                logger.info(f"failure at step {step} ({e}); no checkpoint — "
                            "restarting from scratch")
                params = fresh()
                opt_state = adamw_init(params)
                step = 0
            else:
                logger.info(f"failure at step {step} ({e}); restoring step "
                            f"{latest}")
                state, _ = ckpt.restore({"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                step = latest
    ckpt.save(steps, {"params": params, "opt": opt_state})
    return params, opt_state, {"losses": losses, "restarts": restarts,
                               "stragglers": watchdog.events if watchdog else []}
