"""Analytic per-device HBM byte model (the roofline's memory term),
ported from ``repro/launch/model_costs.py``.

Every formula counts the tensor passes the implementation makes per
device per step: weights streamed per layer, attention KV re-reads,
activation round trips, optimizer state traffic. They are arithmetic
over config fields, bf16 at 2 and fp32 at 4 bytes a pass, and are the
reference's as they are. ``launch/dryrun.py`` divides them by the card's
HBM rate; the op counter's bytes (``launch/op_analysis.py``) stand
beside them as an upper bound from the eager program.
"""
from __future__ import annotations

from repro_torch.configs import get_config

BF16 = 2
F32 = 4


def _lm_bytes(arch, shape, chips: int, tp: int, tuning=None) -> float:
    m = arch.model
    dp = max(chips // tp, 1)
    N = m.param_count
    Na = m.active_param_count
    L, d, V = m.n_layers, m.d_model, m.vocab
    kvh, dh = m.n_kv_heads, m.dh
    t = tuning or {}

    if shape.kind == "train":
        B, S = shape["global_batch"], shape["seq_len"]
        tok_d = B * S / dp
        w_shard = N / tp
        # fwd + backward-dgrad + backward-wgrad weight passes (bf16 compute)
        weights = 3 * w_shard * BF16
        # remat: one extra forward's weight reads
        if m.remat:
            weights += w_shard * BF16
        grads = w_shard * F32 * 2                       # write + opt read
        opt = 6 * (N / (tp * dp)) * F32                 # ZeRO-1 m,v,p r/w
        # activations: ~14 d-wide tensor passes / layer / token (fwd+bwd)
        acts = L * tok_d * d * 14 * BF16 * (2 if m.remat else 1)
        # flash attention: kv re-read nq times per layer (fwd + bwd 2x)
        s_eff = min(S, m.sliding_window or S)
        nq = max(S // max(m.attn_block_q, 1), 1)
        kv_pass = (B / dp) * s_eff * kvh * dh * 2 * BF16
        attn = L * kv_pass * nq * 3
        # vocab head: logits write+read fwd, recompute in bwd
        chunk = t.get("chunked_loss", m.chunked_loss)
        logits = tok_d * (V / tp) * F32 * (2 if chunk else 4)
        return weights + grads + opt + acts + attn + logits

    if shape.kind == "prefill":
        B, S = shape["global_batch"], shape["seq_len"]
        tok_d = B * S / dp
        weights = (Na / tp) * BF16
        acts = L * tok_d * d * 10 * BF16
        s_eff = min(S, m.sliding_window or S)
        nq = max(S // max(m.attn_block_q, 1), 1)
        kv_pass = (B / dp) * s_eff * kvh * dh * 2 * BF16
        attn = L * kv_pass * nq
        cache_write = L * (B / dp) * (min(S, m.sliding_window or S) / 1) \
            * kvh * dh * 2 * BF16 / tp
        logits = (B / dp) * (V / tp) * F32
        return weights + acts + attn + cache_write + logits

    # decode: weights once + full cache read + tiny activations
    B, S = shape["global_batch"], shape["seq_len"]
    s_c = min(S, m.sliding_window or S)
    weights = (Na / tp) * BF16
    kv_item = 1 + 4.0 / dh if t.get("kv_quant") else BF16   # int8 + scales
    cache = L * (B / dp) * (s_c / tp) * kvh * dh * 2 * kv_item
    acts = L * (B / dp) * d * 14 * BF16
    logits = (B / dp) * (V / tp) * F32
    return weights + cache + acts + logits


def _gnn_bytes(arch, shape, chips: int) -> float:
    m = arch.model
    h = m.d_hidden
    d = shape["d_feat"]
    if shape.name == "molecule":
        g, n = shape["batch"], shape["n_nodes"]
        per = g * (n * n * F32 + n * (d + 2 * h) * F32 * 3)
        return per / chips * 3
    if shape.kind == "sampled_train":
        b = shape["batch_nodes"]
        f1, f2 = shape["fanout1"], shape["fanout2"]
        n_eff = b * (1 + f1 + f1 * f2)
        gather = n_eff * d * F32
        acts = b * (f1 + 1) * (d + h) * F32 * 4
        return (gather + acts) / chips * 3
    n, e = shape["n_nodes"], shape["n_edges"]
    msgs = e * (d + h) * F32          # layer-1 + layer-2 message passes
    nodes = n * (d + 4 * h) * F32
    return (msgs + nodes) / chips * 3


def _db_itemsize(tuning) -> int:
    return 2 if (tuning or {}).get("db_dtype", "float32") == "bfloat16" else 4


def _recsys_bytes(arch, shape, chips: int, tp: int, tuning=None) -> float:
    m = arch.model
    if shape.kind == "retrieval":
        n = shape["n_candidates"]
        return (n / chips) * m.embed_dim * _db_itemsize(tuning)
    B = shape["batch"]
    b_d = B / chips
    mult = 3 if shape.kind == "train" else 1
    if m.kind in ("fm", "wide_deep"):
        rows = b_d * m.n_sparse * m.embed_dim * F32
        mlp = 0.0
        dims = (m.n_sparse * m.embed_dim + m.n_dense,) + tuple(m.mlp_dims) + (1,)
        for a, b in zip(dims[:-1], dims[1:]):
            mlp += (a * b / tp) * F32 + b_d * b * F32
        if shape.kind == "train":                    # dense table-grad pass
            rows += (m.n_sparse * m.rows_per_field * m.embed_dim / chips) \
                * F32 * 2
        return (rows + mlp) * mult
    d, s = m.embed_dim, m.seq_len
    if m.kind == "bert4rec":
        acts = b_d * s * d * 14 * F32 * m.n_blocks
        logits = b_d * s * (m.n_items / tp) * F32
        emb = (m.n_items * d / tp) * F32
        return (acts + logits + emb) * mult
    acts = b_d * s * d * (6 + 2 * m.capsule_iters) * F32
    emb = b_d * s * d * F32
    return (acts + emb) * mult


def model_bytes(arch_id: str, shape_name: str, chips: int, tp: int = 16,
                tuning: dict | None = None) -> float:
    """Per-device HBM bytes per step."""
    arch = get_config(arch_id)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return _lm_bytes(arch, shape, chips, tp, tuning)
    if arch.family == "gnn":
        return _gnn_bytes(arch, shape, chips)
    if arch.family == "recsys":
        return _recsys_bytes(arch, shape, chips, tp, tuning)
    # mememo retrieval
    return (shape["n_candidates"] / chips) * shape["dim"] * _db_itemsize(tuning)
