"""Fault-tolerant training on the PyTorch port: injected failures,
checkpoint restart, straggler detection, and exact-replay determinism.

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py --device cpu

What it shows (the 1000-node operating model, at smoke scale):
  1. a supervised run with TWO injected mid-run failures restores from the
     newest checkpoint and continues;
  2. the (seed, step)-deterministic data pipeline makes the recovered run
     bit-match a failure-free run;
  3. the straggler watchdog flags slow steps against a rolling p95.

``main`` returns what it logs as a dict; ``resilient_run`` is one
supervised run, for callers that bring their own checkpoint manager.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import transformer as tf
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StragglerWatchdog, run_resilient
from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
from repro_torch.train.train_loop import make_train_step
from repro_torch.utils import logger, resolve_device

STEPS, CKPT_EVERY, FAIL_AT = 24, 8, (9, 17)


def resilient_run(model: tf.LM, cfg, ckpt: CheckpointManager, *,
                  fail_at=(), watchdog: StragglerWatchdog | None = None):
    """24 steps of ``model`` (never trained itself) under ``run_resilient``,
    a checkpoint every 8 -> (params, opt state, info)."""
    step = make_train_step(lambda p, tokens, labels: tf.lm_loss(
        p, tokens, labels, dtype=torch.float32),
        AdamWConfig(lr=warmup_cosine(1e-3, 5, 40)))

    def batch_fn(s):                      # deterministic in (seed, step)
        return next(lm_batches(cfg.vocab, 8, 33, seed=0, start_step=s))

    return run_resilient(model, step, batch_fn, steps=STEPS, ckpt=ckpt,
                         ckpt_every=CKPT_EVERY, watchdog=watchdog,
                         fail_at=list(fail_at))


def main(cfg=None, device: str = "cuda") -> dict:
    """``cfg``: the LM config (default: llama3-8b's smoke config)."""
    device = resolve_device(device)
    cfg = cfg or get_smoke_config("llama3-8b")
    with tempfile.TemporaryDirectory() as td:
        logger.info("=== run 1: failures injected at steps 9 and 17 ===")
        wd = StragglerWatchdog(min_samples=5, factor=4.0)
        _, _, info1 = resilient_run(
            tf.init_lm(cfg, seed=0, device=device), cfg,
            CheckpointManager(td + "/a", keep=3, async_save=True),
            fail_at=FAIL_AT, watchdog=wd)
        logger.info(f"restarts={info1['restarts']} "
                    f"stragglers={len(info1['stragglers'])} "
                    f"final loss={info1['losses'][STEPS - 1]:.5f}")

        logger.info("=== run 2: failure-free reference ===")
        _, _, info2 = resilient_run(
            tf.init_lm(cfg, seed=0, device=device), cfg,
            CheckpointManager(td + "/b", keep=3))
        logger.info(f"final loss={info2['losses'][STEPS - 1]:.5f}")

        diff = abs(info1["losses"][STEPS - 1] - info2["losses"][STEPS - 1])
        logger.info(f"|recovered - reference| = {diff:.2e} "
                    f"({'EXACT replay' if diff < 2e-3 else 'MISMATCH'})")
        assert diff < 2e-3
    return {"device": str(device), "restarts": info1["restarts"],
            "stragglers": len(info1["stragglers"]),
            "recovered_final_loss": info1["losses"][STEPS - 1],
            "reference_final_loss": info2["losses"][STEPS - 1],
            "diff": diff,
            "recovered_losses": [info1["losses"][s] for s in range(STEPS)],
            "reference_losses": [info2["losses"][s] for s in range(STEPS)]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    main(**vars(ap.parse_args()))
