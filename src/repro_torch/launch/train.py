"""End-to-end training launcher, the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --preset small --steps 300 --batch 8 --seq 128 [--device cpu]

Presets: ``smoke`` (CPU seconds), ``small`` (an LM cut to 4 layers at
d_model 256, ~15M parameters; the other families' published config),
``full`` (the exact published config). Every architecture of the
registry trains: the LMs on ``lm_batches`` through ``lm_loss`` in fp32,
GraphSAGE full-batch on a 2,000-node synthetic graph, and the recsys
models on their synthetic streams. The run is on the card unless
``--device cpu``. Any run is resumable: with ``--ckpt-dir`` it saves
every ``--ckpt-every`` steps, and rerun with the same directory it
restores the newest checkpoint into the live parameters and optimizer
state (one copy of the state) and goes on from that step. As in the
reference, the resumed run draws its batches from the stream's start.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.models.common import count_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.train.train_loop import fit, make_train_step
from repro_torch.utils import human_count, logger, resolve_device


def small_lm(cfg):
    return dataclasses.replace(
        cfg, n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=max(2, cfg.n_kv_heads // 4), d_ff=1024,
        vocab=min(cfg.vocab, 8192),
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2, d_ff=256)
        if cfg.moe else None,
        attn_block_q=64, attn_block_k=64)


def build(arch: str, preset: str, args):
    """-> (model config, params on ``args.device``, loss_fn, batches)."""
    full = get_config(arch)
    if preset == "smoke":
        mcfg = get_smoke_config(arch)
    elif preset == "small" and full.family == "lm":
        mcfg = small_lm(full.model)
    else:
        mcfg = full.model
    dev = resolve_device(args.device)

    if full.family == "lm":
        params = tf.init_lm(mcfg, seed=args.seed, device=dev)
        loss = lambda p, tokens, labels: tf.lm_loss(p, tokens, labels,
                                                    dtype=torch.float32)
        data = synthetic.lm_batches(mcfg.vocab, args.batch, args.seq + 1,
                                    seed=args.seed)
    elif full.family == "gnn":
        graph = synthetic.make_graph(2000, 8, 32, 7, seed=args.seed)
        params = gnn_lib.init_sage(mcfg, 32, 7, seed=args.seed, device=dev)
        feats, src, dst, labels = (
            torch.from_numpy(a).to(dev) for a in (
                graph.feats, graph.edge_src, graph.edge_dst, graph.labels))
        mask = torch.ones(labels.shape, device=dev)
        loss = lambda p, **_: gnn_lib.sage_full_loss(
            p, mcfg, feats, src, dst, labels, mask)
        data = itertools.repeat({})          # full batch: no stream
    else:  # recsys
        params = rs.INIT[mcfg.kind](mcfg, seed=args.seed, device=dev)
        if mcfg.kind in ("fm", "wide_deep"):
            fn = rs.fm_loss if mcfg.kind == "fm" else rs.wide_deep_loss
            loss = lambda p, sparse_ids, dense, labels: fn(
                p, mcfg, sparse_ids, dense, labels)
            data = synthetic.ctr_batches(mcfg.n_sparse, mcfg.rows_per_field,
                                         mcfg.n_dense, args.batch,
                                         seed=args.seed)
        elif mcfg.kind == "bert4rec":
            loss = lambda p, item_seq, labels, label_mask: rs.bert4rec_loss(
                p, mcfg, item_seq, labels, label_mask)
            data = synthetic.masked_item_batches(mcfg.n_items, mcfg.seq_len,
                                                 args.batch, seed=args.seed)
        else:
            loss = lambda p, behavior, behavior_mask, target, neg: \
                rs.mind_loss(p, mcfg, behavior, behavior_mask, target, neg)
            data = synthetic.seq_rec_batches(mcfg.n_items, mcfg.seq_len,
                                             args.batch, seed=args.seed)
    return mcfg, params, loss, data


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "small", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu for the "
                         "plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train ``--arch`` for ``--steps`` steps -> {arch, preset, device,
    params, start_step, history} (history: fit's {step, loss, sec} a
    step; start_step: the step a resumed run went on from, else 0)."""
    args = parse_args(argv)
    mcfg, params, loss_fn, data = build(args.arch, args.preset, args)
    n_params = count_params(params)
    logger.info(f"arch={args.arch} preset={args.preset} "
                f"params={human_count(n_params)}")

    opt_cfg = AdamWConfig(
        lr=warmup_cosine(args.lr, max(args.steps // 20, 5), args.steps))
    step_fn = make_train_step(loss_fn, opt_cfg, microbatches=args.microbatches)

    ckpt = None
    start, opt_state = 0, None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
        latest = ckpt.latest_step()
        if latest:
            opt_state = adamw_init(params)
            ckpt.restore({"params": params, "opt": opt_state}, inplace=True)
            start = latest
            logger.info(f"resumed from step {latest}")

    t0 = time.time()
    params, opt_state, hist = fit(
        params, step_fn, data, steps=args.steps, ckpt=ckpt,
        ckpt_every=args.ckpt_every, opt_state=opt_state, start_step=start)
    if hist:
        dt = time.time() - t0
        logger.info(f"done: loss {hist[0]['loss']:.4f} -> "
                    f"{hist[-1]['loss']:.4f} ({len(hist)} steps, {dt:.0f}s, "
                    f"{len(hist)/dt:.2f} steps/s)")
    if ckpt:
        ckpt.wait()
    return {"arch": args.arch, "preset": args.preset,
            "device": str(resolve_device(args.device)), "params": n_params,
            "start_step": start, "history": hist}


if __name__ == "__main__":
    main()
