"""Deterministic synthetic data pipeline (seeded, shard-aware), the numpy
copy of ``repro/data/synthetic.py``: the same seeds give the same batches,
bit for bit.

Every generator yields numpy batches from a counting PRNG stream, so any
batch index is reproducible from (seed, step) alone — which is what lets a
restarted/re-sharded training job replay the exact stream from its restored
step (fault tolerance without data-loader state).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------
def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               start_step: int = 0, dp_rank: int = 0, dp_size: int = 1
               ) -> Iterator[dict]:
    """Markov-ish synthetic token stream (not uniform: gives learnable
    structure so loss decreases in the e2e example)."""
    step = start_step
    while True:
        rng = _rng(seed, step * dp_size + dp_rank)
        base = rng.integers(0, vocab, size=(batch, 1))
        drift = rng.integers(-16, 17, size=(batch, seq)).cumsum(axis=1)
        toks = np.abs(base + drift) % vocab
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        step += 1


# ---------------------------------------------------------------------------
# RecSys streams
# ---------------------------------------------------------------------------
def ctr_batches(n_sparse: int, rows_per_field: int, n_dense: int, batch: int,
                *, seed: int = 0, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        rng = _rng(seed, step)
        ids = rng.zipf(1.2, size=(batch, n_sparse)) % rows_per_field
        dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
        # planted linear signal so training can actually fit something
        w = np.random.default_rng(seed).normal(size=n_dense)
        logit = dense @ w + 0.1 * (ids.sum(-1) % 7 - 3)
        y = (logit + rng.logistic(size=batch) > 0).astype(np.int32)
        yield {"sparse_ids": ids.astype(np.int32), "dense": dense, "labels": y}
        step += 1


def seq_rec_batches(n_items: int, seq_len: int, batch: int, *, seed: int = 0,
                    start_step: int = 0, n_neg: int = 16) -> Iterator[dict]:
    step = start_step
    while True:
        rng = _rng(seed, step)
        # clustered user tastes: items drawn around a per-user center
        center = rng.integers(0, n_items, size=(batch, 1))
        seq = (center + rng.integers(-50, 51, size=(batch, seq_len))) % n_items
        target = (center[:, 0] + rng.integers(-50, 51, size=batch)) % n_items
        neg = rng.integers(0, n_items, size=(batch, n_neg))
        mask_len = rng.integers(seq_len // 2, seq_len + 1, size=batch)
        mask = (np.arange(seq_len)[None] < mask_len[:, None])
        yield {"behavior": seq.astype(np.int32),
               "behavior_mask": mask.astype(np.float32),
               "target": target.astype(np.int32),
               "neg": neg.astype(np.int32)}
        step += 1


def masked_item_batches(n_items: int, seq_len: int, batch: int, *,
                        seed: int = 0, start_step: int = 0,
                        mask_rate: float = 0.2) -> Iterator[dict]:
    mask_id = n_items          # reserved token
    step = start_step
    while True:
        rng = _rng(seed, step)
        center = rng.integers(0, n_items, size=(batch, 1))
        seq = (center + rng.integers(-50, 51, size=(batch, seq_len))) % n_items
        m = rng.random((batch, seq_len)) < mask_rate
        inp = np.where(m, mask_id, seq)
        yield {"item_seq": inp.astype(np.int32),
               "labels": seq.astype(np.int32),
               "label_mask": m.astype(np.float32)}
        step += 1


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SyntheticGraph:
    feats: np.ndarray       # [N, D]
    labels: np.ndarray      # [N]
    edge_src: np.ndarray    # [E]
    edge_dst: np.ndarray    # [E]
    row_ptr: np.ndarray     # CSR
    col_idx: np.ndarray


def make_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
               *, seed: int = 0) -> SyntheticGraph:
    """Community graph: labels = communities; features = noisy label means —
    so GraphSAGE aggregation genuinely helps (homophily)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    e = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, size=e)
    same = rng.random(e) < 0.7
    # intra-community edge: pick dst with the same label via label buckets
    buckets = [np.where(labels == c)[0] for c in range(n_classes)]
    dst = rng.integers(0, n_nodes, size=e)        # default: random edge
    for c in range(n_classes):
        sel = same & (labels[src] == c)
        if sel.any() and len(buckets[c]):
            dst[sel] = rng.choice(buckets[c], size=int(sel.sum()))
    centers = rng.normal(size=(n_classes, d_feat)) * 2.0
    feats = centers[labels] + rng.normal(size=(n_nodes, d_feat))
    from repro_torch.models.sampler import make_csr
    row_ptr, col_idx = make_csr(n_nodes, src, dst)
    return SyntheticGraph(feats.astype(np.float32), labels.astype(np.int32),
                          src.astype(np.int32), dst.astype(np.int32),
                          row_ptr, col_idx)


def molecule_batches(batch: int, n_nodes: int, d_feat: int, n_classes: int,
                     *, seed: int = 0, start_step: int = 0,
                     edge_p: float = 0.15) -> Iterator[dict]:
    step = start_step
    while True:
        rng = _rng(seed, step)
        adj = (rng.random((batch, n_nodes, n_nodes)) < edge_p)
        adj = np.maximum(adj, adj.transpose(0, 2, 1)).astype(np.float32)
        feats = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
        labels = (adj.sum((1, 2)) > edge_p * n_nodes * n_nodes).astype(np.int32) \
            % n_classes
        yield {"feats": feats, "adj": adj, "labels": labels}
        step += 1


# ---------------------------------------------------------------------------
# Retrieval corpora (clustered: realistic ANN difficulty)
# ---------------------------------------------------------------------------
def make_corpus(n: int, dim: int, *, n_clusters: int = 64, seed: int = 0
                ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 1.5
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign]
            + rng.normal(size=(n, dim)).astype(np.float32)).astype(np.float32)
