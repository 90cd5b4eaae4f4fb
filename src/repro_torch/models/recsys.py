"""RecSys model zoo: FM, Wide&Deep, BERT4Rec, MIND, ported from
``repro/models/recsys.py``.

The memory is in the sparse embedding tables (n_fields x 10^6 rows),
stacked [F, R, K]; a lookup is a plain advanced-index gather, one id per
field (the reference's too: neither calls ``embedding_bag``).

Parameters are the reference's trees of tensors (``init_*``, drawn from
a ``torch.Generator``; ``convert.recsys_params_from_jax`` carries the
reference's own), matrices laid out for ``x @ W``; BERT4Rec's backbone
is a ``models.encoder.Encoder``. The trees have the reference's shapes,
so each ``*_param_axes`` gives the reference's logical axes, keyed as
``models.common.named_tensors`` (``deep.0.w``). Every model also exposes
its user embedding, so the ``retrieval_cand`` cell routes through the
retrieval core: one user's queries against the 1M-item table through
``core.flat.FlatIndex(metric="ip")`` and so ``ops.flat_topk`` (MeMemo's
own workload).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import encoder as enc_lib
from repro_torch.models.common import (
    l2_normalize,
    normal_init,
    sigmoid_xent,
    softmax_xent,
)
from repro_torch.utils import generator


# ---------------------------------------------------------------------------
# Shared: sparse table lookup
# ---------------------------------------------------------------------------
def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [F,R,K], ids [B,F] -> [B,F,K] (one id per field); a per-row
    weight table [F,R] gives [B,F]."""
    f = table.shape[0]
    fields = torch.arange(f, device=table.device)[None, :]
    return table[fields, ids.long()]


def _mlp_init(generator: torch.Generator, dims: tuple[int, ...]
              ) -> list[dict]:
    return [{"w": normal_init(generator, (a, b), (2.0 / a) ** 0.5),
             "b": torch.zeros(b, device=generator.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers: list[dict], x: torch.Tensor,
               final_act: bool = False) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1 or final_act:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------------------
# FM — pairwise interactions via the O(nk) sum-square trick (Rendle ICDM'10)
# ---------------------------------------------------------------------------
def init_fm(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    g = generator(seed, device)
    F_, R, K = cfg.n_sparse, cfg.rows_per_field, cfg.embed_dim
    return {
        "table": normal_init(g, (F_, R, K), 0.01),
        "w_sparse": normal_init(g, (F_, R), 0.01),      # per-field linear
        "w_dense": normal_init(g, (cfg.n_dense, 1), 0.01),
        "v_dense": normal_init(g, (cfg.n_dense, K), 0.01),
        "bias": torch.zeros((), device=g.device),
    }


def fm_param_axes(cfg: RecsysConfig) -> dict:
    return {"table": ("fields", "table_rows", "feature_dim"),
            "w_sparse": ("fields", "table_rows"),
            "w_dense": (None, None), "v_dense": (None, "feature_dim"),
            "bias": ()}


def fm_forward(params: dict, cfg: RecsysConfig, sparse_ids: torch.Tensor,
               dense: torch.Tensor) -> torch.Tensor:
    """sparse_ids [B,F] int, dense [B,n_dense] -> logits [B]."""
    emb = lookup(params["table"], sparse_ids)                       # [B,F,K]
    lin_s = lookup(params["w_sparse"], sparse_ids)             # [B,F]
    lin = (torch.sum(lin_s, -1) + (dense @ params["w_dense"])[:, 0]
           + params["bias"])
    # dense features as value-scaled factors: v_i * x_i
    vx_dense = params["v_dense"][None] * dense[..., None]          # [B,nd,K]
    vx = torch.cat([emb, vx_dense], dim=1)                          # [B,F+nd,K]
    s = torch.sum(vx, dim=1)                                        # Σ v_i x_i
    s2 = torch.sum(torch.square(vx), dim=1)                         # Σ (v_i x_i)²
    pair = 0.5 * torch.sum(torch.square(s) - s2, dim=-1)            # [B]
    return lin + pair


def fm_loss(params, cfg, sparse_ids, dense, labels):
    return sigmoid_xent(fm_forward(params, cfg, sparse_ids, dense), labels)


# ---------------------------------------------------------------------------
# Wide & Deep
# ---------------------------------------------------------------------------
def init_wide_deep(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    g = generator(seed, device)
    F_, R, K = cfg.n_sparse, cfg.rows_per_field, cfg.embed_dim
    mlp_dims = (F_ * K + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
    return {
        "table": normal_init(g, (F_, R, K), 0.01),
        "wide": normal_init(g, (F_, R), 0.01),          # wide = linear on sparse
        "wide_dense": normal_init(g, (cfg.n_dense, 1), 0.01),
        "deep": _mlp_init(g, mlp_dims),
        "bias": torch.zeros((), device=g.device),
    }


def wide_deep_param_axes(cfg: RecsysConfig) -> dict:
    n_mlp = len(cfg.mlp_dims) + 1
    axes = {"table": ("fields", "table_rows", "feature_dim"),
            "wide": ("fields", "table_rows"),
            "wide_dense": (None, None)}
    for i in range(n_mlp):
        axes[f"deep.{i}.w"] = (None, "mlp") if i == 0 else ("mlp", None)
        axes[f"deep.{i}.b"] = ("mlp",) if i == 0 else (None,)
    axes["bias"] = ()
    return axes


def wide_deep_forward(params: dict, cfg: RecsysConfig,
                      sparse_ids: torch.Tensor,
                      dense: torch.Tensor) -> torch.Tensor:
    B = sparse_ids.shape[0]
    emb = lookup(params["table"], sparse_ids).reshape(B, -1)        # [B,F*K]
    deep_in = torch.cat([emb, dense], dim=-1)
    deep = _mlp_apply(params["deep"], deep_in)[:, 0]
    wide_s = lookup(params["wide"], sparse_ids)
    wide = torch.sum(wide_s, -1) + (dense @ params["wide_dense"])[:, 0]
    return deep + wide + params["bias"]


def wide_deep_loss(params, cfg, sparse_ids, dense, labels):
    return sigmoid_xent(wide_deep_forward(params, cfg, sparse_ids, dense),
                        labels)


# ---------------------------------------------------------------------------
# BERT4Rec — bidirectional encoder over item sequences, masked-item loss
# ---------------------------------------------------------------------------
def _bert4rec_enc_cfg(cfg: RecsysConfig) -> enc_lib.EncoderConfig:
    # +mask +pad, then padded to a multiple of 256 as the reference pads
    # it for its mesh: the vocab is part of the parameter layout
    vocab = cfg.n_items + 2
    vocab += (-vocab) % 256
    return enc_lib.EncoderConfig(
        vocab=vocab,
        d_model=cfg.embed_dim,
        n_blocks=cfg.n_blocks,
        n_heads=cfg.n_heads,
        d_ff=4 * cfg.embed_dim,
        max_len=cfg.seq_len,
        pool="none",
    )


def init_bert4rec(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    return {"encoder": enc_lib.init_encoder(_bert4rec_enc_cfg(cfg), seed,
                                            device)}


def bert4rec_param_axes(cfg: RecsysConfig) -> dict:
    return {f"encoder.{n}": axes for n, axes in
            enc_lib.encoder_param_axes(_bert4rec_enc_cfg(cfg)).items()}


def _bert4rec_hidden(params, cfg: RecsysConfig, item_seq) -> torch.Tensor:
    return enc_lib.encoder_forward(params["encoder"], _bert4rec_enc_cfg(cfg),
                                   item_seq)


def bert4rec_scores(params, cfg: RecsysConfig,
                    item_seq: torch.Tensor) -> torch.Tensor:
    """item_seq [B,S] -> per-position item logits [B,S,V] (tied to the
    item embedding; V the padded vocab)."""
    h = _bert4rec_hidden(params, cfg, item_seq)
    return h.float() @ params["encoder"].embed.T


def bert4rec_loss(params, cfg: RecsysConfig, item_seq, labels, label_mask):
    """Masked-item prediction (positions with label_mask==1)."""
    return softmax_xent(bert4rec_scores(params, cfg, item_seq), labels,
                        label_mask)


def bert4rec_masked_loss(params, cfg: RecsysConfig, item_seq, masked_pos,
                         labels) -> torch.Tensor:
    """Fixed-count masked-position loss: the hidden states at ``M``
    pre-chosen positions gathered before the vocab projection, so the
    logits are [B, M, V] instead of [B, S, V]."""
    h = _bert4rec_hidden(params, cfg, item_seq)                      # [B,S,D]
    idx = masked_pos.long()[..., None].expand(-1, -1, h.shape[-1])
    hm = torch.gather(h, 1, idx)                                     # [B,M,D]
    logits = hm.float() @ params["encoder"].embed.T
    return softmax_xent(logits, labels)


def bert4rec_user_embedding(params, cfg: RecsysConfig,
                            item_seq) -> torch.Tensor:
    """Sequence-level user vector = last-position hidden (for retrieval)."""
    h = _bert4rec_hidden(params, cfg, item_seq)
    return l2_normalize(h[:, -1], dim=-1)


# ---------------------------------------------------------------------------
# MIND — multi-interest extraction via B2I dynamic (capsule) routing
# ---------------------------------------------------------------------------
def init_mind(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    g = generator(seed, device)
    K = cfg.embed_dim
    return {
        "items": normal_init(g, (cfg.n_items, K), 0.02),
        "s_matrix": normal_init(g, (K, K), 0.02),       # bilinear routing map
        "mlp": _mlp_init(g, (K,) + tuple(cfg.mlp_dims) + (K,)),
    }


def mind_param_axes(cfg: RecsysConfig) -> dict:
    axes = {"items": ("table_rows", "feature_dim"), "s_matrix": (None, None)}
    for i in range(len(cfg.mlp_dims) + 1):
        axes[f"mlp.{i}.w"] = (None, None)
        axes[f"mlp.{i}.b"] = (None,)
    return axes


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def mind_interests(params, cfg: RecsysConfig, behavior: torch.Tensor,
                   behavior_mask: torch.Tensor) -> torch.Tensor:
    """behavior [B,S] item ids (+mask [B,S]) -> interests [B,I,K].

    B2I dynamic routing: ``capsule_iters - 1`` routing iterations whose
    logits are no gradient target (``detach``, the reference's
    ``stop_gradient``), then the capsules. The routing logits start at
    zero, as in the reference, so the softmax over interests is uniform
    and stays so: every interest of a user comes out the same."""
    B, S = behavior.shape
    I = cfg.n_interests
    e = params["items"][behavior.long()]                             # [B,S,K]
    eh = e @ params["s_matrix"]                                      # [B,S,K]
    mask = behavior_mask.float()
    logits = torch.zeros((B, I, S), device=e.device)
    ehd = eh.detach()
    for _ in range(max(cfg.capsule_iters - 1, 0)):
        w = torch.softmax(logits, dim=1) * mask[:, None, :]          # over I
        cap = _squash(torch.einsum("bis,bsk->bik", w, ehd))
        logits = logits + torch.einsum("bik,bsk->bis", cap, ehd)
    w = torch.softmax(logits, dim=1) * mask[:, None, :]
    caps = _squash(torch.einsum("bis,bsk->bik", w, eh))
    out = caps + _mlp_apply(params["mlp"], caps, final_act=False)
    return l2_normalize(out, dim=-1)


def mind_loss(params, cfg: RecsysConfig, behavior, behavior_mask, target,
              neg_items) -> torch.Tensor:
    """Label-aware attention + sampled softmax over [target; negatives]."""
    interests = mind_interests(params, cfg, behavior, behavior_mask)
    tgt = params["items"][target.long()]                             # [B,K]
    neg = params["items"][neg_items.long()]                          # [B,N,K]
    # label-aware attention: pow(softmax) over interests wrt the target
    att = torch.einsum("bik,bk->bi", interests, tgt)
    att = torch.softmax(2.0 * att, dim=-1)
    user = torch.einsum("bi,bik->bk", att, interests)                # [B,K]
    cand = torch.cat([tgt[:, None], neg], dim=1)                     # [B,1+N,K]
    logits = torch.einsum("bk,bnk->bn", user, cand)
    labels = torch.zeros(behavior.shape[0], dtype=torch.long,
                         device=logits.device)
    return softmax_xent(logits, labels)


def mind_user_embedding(params, cfg: RecsysConfig, behavior,
                        behavior_mask) -> torch.Tensor:
    """Max-scoring retrieval uses all interests: [B,I,K]."""
    return mind_interests(params, cfg, behavior, behavior_mask)


# ---------------------------------------------------------------------------
# Uniform entry points
# ---------------------------------------------------------------------------
INIT = {"fm": init_fm, "wide_deep": init_wide_deep,
        "bert4rec": init_bert4rec, "mind": init_mind}
AXES = {"fm": fm_param_axes, "wide_deep": wide_deep_param_axes,
        "bert4rec": bert4rec_param_axes, "mind": mind_param_axes}
