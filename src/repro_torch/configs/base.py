"""Config dataclasses for every architecture family + shape specs.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (exact published dims) and ``smoke_config()`` (reduced same-family
config for CPU smoke tests).  The registry in ``__init__`` resolves
``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | sampled_train | serve | retrieval
    dims: dict[str, int] = dataclasses.field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    ShapeSpec("minibatch_lg", "sampled_train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout1": 15, "fanout2": 10, "d_feat": 602, "n_classes": 41}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100, "n_classes": 47}),
    ShapeSpec("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "n_classes": 2}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"
    # EP alignment: pad the expert dim to a mesh-divisible count; padded
    # experts are masked out of routing (never receive tokens). 0 = off.
    pad_experts_to: int = 0

    @property
    def n_slots(self) -> int:
        return max(self.pad_experts_to, self.n_experts)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None   # SWA width; None = full attention
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    # implementation knobs (hillclimb levers)
    attn_block_q: int = 512      # blocked-attention query tile
    attn_block_k: int = 1024     # blocked-attention key tile
    chunked_loss: int = 0        # 0 = full logits; >0 = vocab-loss seq chunk size
    remat: bool = True           # activation checkpointing on layer scan
    scan_layers: bool = True
    kv_quant: bool = False       # int8 KV cache (+per-position f32 scales)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def param_count(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh \
            + self.n_heads * self.dh * d
        if self.moe:
            ffn = 3 * d * self.moe.d_ff * self.moe.n_experts + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count
        d, v, L = self.d_model, self.vocab, self.n_layers
        attn = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh \
            + self.n_heads * self.dh * d
        ffn = 3 * d * self.moe.d_ff * self.moe.top_k + d * self.moe.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    sample_sizes: tuple[int, ...] = (25, 10)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                    # fm | wide_deep | bert4rec | mind
    embed_dim: int
    n_sparse: int = 0
    rows_per_field: int = 1_000_000     # synthetic hashed vocab per sparse field
    n_dense: int = 13                   # criteo-style dense features
    mlp_dims: tuple[int, ...] = ()
    # sequential models
    seq_len: int = 0
    n_items: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0
    interaction: str = ""

    @property
    def table_param_count(self) -> int:
        if self.kind in ("bert4rec", "mind"):
            return self.n_items * self.embed_dim
        return self.n_sparse * self.rows_per_field * self.embed_dim


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """MeMemo's own configuration (paper section 3, Code 1 parity)."""
    name: str = "mememo"
    dim: int = 384                     # GTE-small embeddings (paper section 2.1)
    metric: str = "cosine"
    M: int = 5                         # paper section 5 benchmark setting
    ef_construction: int = 20
    ef_search: int = 64
    prefetch_p: int = 0                # 0 -> auto from dim (paper section 3.2)
    n_vectors: int = 1_000_000
    # VectorIndex backend selection (core/index.py make_index): the paper's
    # own index is HNSW; flat/ivf/tiered serve other workload points.
    index_kind: str = "hnsw"
    nlist: int = 64                    # ivf: number of inverted lists
    nprobe: int = 8                    # ivf: lists probed per query
    # row-storage codec (DESIGN.md §9): None -> backend default (fp32);
    # "bf16"/"int8" shrink device blocks + snapshot pages per vector
    index_dtype: str | None = None
    # layer-0 beam implementation (DESIGN.md §12): None -> backend
    # default ("fused" one-launch kernel); "jnp" is the per-hop
    # while_loop reference path
    beam_impl: str | None = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                        # lm | gnn | recsys
    model: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    skip_shapes: tuple[str, ...] = ()  # mandated skips (noted in DESIGN.md)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def runnable_shapes(self) -> tuple[ShapeSpec, ...]:
        return tuple(s for s in self.shapes if s.name not in self.skip_shapes)
