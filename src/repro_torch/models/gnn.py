"""GraphSAGE (mean aggregator) in three regimes, ported from
``repro/models/gnn.py``:

  * full graph (full_graph_sm, ogb_products): gather the source features
    [E,D], sum them into their destination nodes, normalise by degree.
    The edges are ordered by destination once a forward (a stable sort,
    so each node's edges keep their order), and each node's sum is one
    segment of ``torch.segment_reduce``: no float atomics, so two runs
    on the card agree bit for bit. The reference's edge groups collapse
    to one group without a mesh, which is this single segment sum;
  * sampled (minibatch_lg): dense fanout tensors [B,f1,f2,D] from the
    neighbour sampler (``models.sampler``), means and matrix products;
  * batched small graphs (molecule): a dense normalised adjacency product
    per graph.

Parameters are the reference's tree (``init_sage``; matrices laid out for
``x @ W``), drawn from a ``torch.Generator``; ``sage_param_axes`` gives
the reference's logical axes, keyed as ``models.common.named_tensors``.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.models.common import l2_normalize, normal_init, softmax_xent
from repro_torch.models.sampler import sample_neighbors
from repro_torch.utils import generator


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def init_sage(cfg: GNNConfig, d_feat: int, n_classes: int, seed: int = 0,
              device=None) -> dict:
    g = generator(seed, device)
    dims = [d_feat] + [cfg.d_hidden] * cfg.n_layers
    layers = []
    for i in range(cfg.n_layers):
        scale = (2.0 / dims[i]) ** 0.5
        layers.append({
            "w_self": normal_init(g, (dims[i], dims[i + 1]), scale),
            "w_neigh": normal_init(g, (dims[i], dims[i + 1]), scale),
            "b": torch.zeros(dims[i + 1], device=g.device),
        })
    return {"layers": layers,
            "w_out": normal_init(g, (cfg.d_hidden, n_classes), 0.02)}


def sage_param_axes(cfg: GNNConfig) -> dict:
    axes = {}
    for i in range(cfg.n_layers):
        axes.update({f"layers.{i}.w_self": ("node_feat", None),
                     f"layers.{i}.w_neigh": ("node_feat", None),
                     f"layers.{i}.b": (None,)})
    axes["w_out"] = (None, None)
    return axes


def _sage_layer(lp: dict, h_self: torch.Tensor, h_agg: torch.Tensor,
                final: bool) -> torch.Tensor:
    out = h_self @ lp["w_self"] + h_agg @ lp["w_neigh"] + lp["b"]
    out = out if final else F.relu(out)
    return l2_normalize(out, dim=-1)


# ---------------------------------------------------------------------------
# Full-graph forward (full_graph_sm / ogb_products)
# ---------------------------------------------------------------------------
def sage_full_forward(params: dict, cfg: GNNConfig, feats: torch.Tensor,
                      edge_src: torch.Tensor,
                      edge_dst: torch.Tensor) -> torch.Tensor:
    """feats [N,D]; edge_src/dst [E] int -> logits [N,C]."""
    n = feats.shape[0]
    order = torch.argsort(edge_dst, stable=True)
    src = edge_src.long()[order]
    # in-degrees from the sorted destinations (bincount's, without its
    # data-dependent length, so the forward also runs on ``meta``)
    bounds = torch.searchsorted(edge_dst.long()[order],
                                torch.arange(n + 1, device=edge_dst.device))
    deg = bounds[1:] - bounds[:-1]                                   # [N]
    inv_deg = 1.0 / torch.clamp_min(deg.float(), 1.0)
    h = feats
    for lp in params["layers"]:
        msg = h[src]                                                 # [E,D]
        agg = torch.segment_reduce(msg, "sum", lengths=deg, axis=0)
        h = _sage_layer(lp, h, agg * inv_deg[:, None], final=False)
    return h @ params["w_out"]


def sage_full_loss(params, cfg, feats, edge_src, edge_dst, labels,
                   label_mask):
    logits = sage_full_forward(params, cfg, feats, edge_src, edge_dst)
    return softmax_xent(logits, labels, label_mask)


# ---------------------------------------------------------------------------
# Sampled minibatch forward (minibatch_lg): dense fanout tensors
# ---------------------------------------------------------------------------
def sage_sampled_forward(params: dict, cfg: GNNConfig, x_self: torch.Tensor,
                         x_n1: torch.Tensor,
                         x_n2: torch.Tensor) -> torch.Tensor:
    """x_self [B,D], x_n1 [B,f1,D], x_n2 [B,f1,f2,D] -> logits [B,C].

    Two-layer SAGE on the sampled tree (fanout f1, f2): layer 1 embeds the
    depth-1 frontier (aggregating depth 2), layer 2 embeds the seeds."""
    if cfg.n_layers != 2:
        raise ValueError("the sampled path implements the 2-layer config")
    l1, l2 = params["layers"]
    h_n1 = _sage_layer(l1, x_n1, torch.mean(x_n2, dim=2), final=False)
    h_self = _sage_layer(l1, x_self, torch.mean(x_n1, dim=1), final=False)
    h = _sage_layer(l2, h_self, torch.mean(h_n1, dim=1), final=False)
    return h @ params["w_out"]


def sage_sampled_loss(params, cfg, x_self, x_n1, x_n2, labels):
    logits = sage_sampled_forward(params, cfg, x_self, x_n1, x_n2)
    return softmax_xent(logits, labels)


def sample_tree(generator: torch.Generator, row_ptr, col_idx, feats, seeds,
                fanouts):
    """The sampled tree of ``seeds``: depth-1 ids [B, f1] and depth-2 ids
    [B*f1, f2] drawn from ``generator``, and their features (x_self,
    x_n1, x_n2) gathered from ``feats``."""
    f1, f2 = fanouts
    n1 = sample_neighbors(generator, row_ptr, col_idx, seeds, f1)
    n2 = sample_neighbors(generator, row_ptr, col_idx, n1.reshape(-1), f2)
    b = seeds.shape[0]
    x_self = feats[seeds.long()]
    x_n1 = feats[n1.reshape(-1).long()].reshape(b, f1, -1)
    x_n2 = feats[n2.reshape(-1).long()].reshape(b, f1, f2, -1)
    return (n1, n2), (x_self, x_n1, x_n2)


def sampled_train_from_graph(params, cfg, row_ptr, col_idx, feats, seeds,
                             labels, generator: torch.Generator, fanouts):
    """End-to-end sampled loss value: neighbour sampling, the feature
    gather and SAGE (minibatch_lg), the graph on ``generator``'s device."""
    _, xs = sample_tree(generator, row_ptr, col_idx, feats, seeds, fanouts)
    return sage_sampled_loss(params, cfg, *xs, labels)


# ---------------------------------------------------------------------------
# Batched small graphs (molecule): dense adjacency product
# ---------------------------------------------------------------------------
def sage_molecule_forward(params: dict, cfg: GNNConfig, feats: torch.Tensor,
                          adj: torch.Tensor) -> torch.Tensor:
    """feats [G,n,D], adj [G,n,n] (0/1) -> graph logits [G,C]."""
    deg = torch.clamp_min(torch.sum(adj, dim=-1, keepdim=True), 1.0)
    h = feats
    for lp in params["layers"]:
        h = _sage_layer(lp, h, torch.bmm(adj, h) / deg, final=False)
    return torch.mean(h, dim=1) @ params["w_out"]


def sage_molecule_loss(params, cfg, feats, adj, labels):
    logits = sage_molecule_forward(params, cfg, feats, adj)
    return softmax_xent(logits, labels)
