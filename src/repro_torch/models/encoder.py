"""Bidirectional transformer encoder (pre-LN, GELU FFN, learned positions),
ported from ``repro/models/encoder.py``.

Two consumers:
  * the RAG query/document embedder (GTE-small-style, 384-d — paper §2.1);
  * the BERT4Rec backbone (items as vocab, masked-item training).

``Encoder`` holds the reference's parameters in its layout: the blocks
stacked along a leading [L] axis, matrices laid out for ``x @ W``.
``encoder_forward`` computes at ``dtype`` as the reference does: each
weight cast to it where it is used, the products summed in fp32 and cast
back, the norms in fp32, the FFN's hidden layer in fp32. Each block runs
under ``torch.utils.checkpoint`` (the reference's per-block
``jax.checkpoint``): a backward recomputes a block's activations rather
than holding every block's attention intermediates.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import blocked_attention
from repro_torch.models.common import (
    l2_normalize,
    layer_norm,
    linear,
    linear_f32,
    normal_init,
    weight,
)
from repro_torch.utils import generator, resolve_device


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab: int
    d_model: int
    n_blocks: int
    n_heads: int
    d_ff: int
    max_len: int
    norm_eps: float = 1e-12
    pool: str = "mean"          # mean | cls | none


# name -> (shape from (L, D, F), init: "ones" | "zeros" | std scale)
def _layer_shapes(cfg: EncoderConfig) -> dict:
    L, D, F = cfg.n_blocks, cfg.d_model, cfg.d_ff
    out = 0.02 / (2 * L) ** 0.5
    return {"ln1_g": ((L, D), "ones"), "ln1_b": ((L, D), "zeros"),
            "ln2_g": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
            "wqkv": ((L, D, 3 * D), 0.02), "wo": ((L, D, D), out),
            "w1": ((L, D, F), 0.02), "b1": ((L, F), "zeros"),
            "w2": ((L, F, D), out), "b2": ((L, D), "zeros")}


class Encoder(nn.Module):
    """The reference's ``init_encoder`` tree as fp32 parameters:
    ``embed``, ``pos``, ``layers.<name>`` and ``final_g``/``final_b``."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.embed = p(cfg.vocab, cfg.d_model)
        self.pos = p(cfg.max_len, cfg.d_model)
        self.layers = nn.ParameterDict(
            {name: p(*shape) for name, (shape, _) in
             _layer_shapes(cfg).items()})
        self.final_g = p(cfg.d_model)
        self.final_b = p(cfg.d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's scheme: N(0, 0.02) embeddings and matrices, the
        output projections scaled by (2L)^-1/2, unit gains, zero biases."""
        self.embed.copy_(normal_init(generator, self.embed.shape))
        self.pos.copy_(normal_init(generator, self.pos.shape))
        for name, (_, init) in _layer_shapes(self.cfg).items():
            w = self.layers[name]
            if init == "ones":
                w.fill_(1.0)
            elif init == "zeros":
                w.zero_()
            else:
                w.copy_(normal_init(generator, w.shape, init))
        self.final_g.fill_(1.0)
        self.final_b.zero_()


def encoder_param_axes(cfg: EncoderConfig) -> dict:
    """The reference's logical axes, keyed as ``Encoder``'s parameters
    (its layers stacked along [L], as there)."""
    layer = {"ln1_g": ("layers", "embed"), "ln1_b": ("layers", "embed"),
             "ln2_g": ("layers", "embed"), "ln2_b": ("layers", "embed"),
             "wqkv": ("layers", "embed", "heads"),
             "wo": ("layers", "heads", "embed"),
             "w1": ("layers", "embed", "mlp"), "b1": ("layers", "mlp"),
             "w2": ("layers", "mlp", "embed"), "b2": ("layers", "embed")}
    return {"embed": ("vocab", "embed"), "pos": (None, "embed"),
            **{f"layers.{n}": a for n, a in layer.items()},
            "final_g": ("embed",), "final_b": ("embed",)}


def init_encoder(cfg: EncoderConfig, seed: int = 0, device=None) -> Encoder:
    """An encoder with random weights drawn on ``device`` (default cuda)
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    model = Encoder(cfg, device="meta").to_empty(device=dev)
    model.reset_parameters(generator(seed, dev))
    model.requires_grad_(False)
    return model.eval()


def _mm(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``dtype``, summed in fp32, cast back."""
    return linear(x, weight(w, dtype).T)


def _mm_f32(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``dtype``, the fp32 sum kept."""
    return linear_f32(x, weight(w, dtype).T)


def _block(model: Encoder, cfg: EncoderConfig, dtype, i: int,
           x: torch.Tensor) -> torch.Tensor:
    """Block ``i`` on x [B,S,D]."""
    B, S, D = x.shape
    H = cfg.n_heads
    lp = {name: w[i] for name, w in model.layers.items()}
    h = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    q, k, v = torch.chunk(_mm(h, lp["wqkv"], dtype), 3, dim=-1)
    attn = blocked_attention(q.reshape(B, S, H, D // H),
                             k.reshape(B, S, H, D // H),
                             v.reshape(B, S, H, D // H), causal=False,
                             block_q=min(256, S), block_k=min(256, S))
    x = x + _mm(attn.reshape(B, S, D), lp["wo"], dtype)
    h = layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    g = F.gelu(_mm_f32(h, lp["w1"], dtype) + lp["b1"].float(),
               approximate="tanh")
    return x + _mm(g.to(dtype), lp["w2"], dtype) + lp["b2"].to(dtype)


def encoder_forward(model: Encoder, cfg: EncoderConfig, tokens: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    dtype=torch.float32) -> torch.Tensor:
    """tokens [B,S] -> hidden [B,S,D] (or pooled [B,D] per cfg.pool)."""
    S = tokens.shape[1]
    x = (model.embed[tokens.long()] + model.pos[None, :S]).to(dtype)
    remat = torch.is_grad_enabled()     # a served forward keeps nothing
    for i in range(cfg.n_blocks):
        x = (checkpoint(_block, model, cfg, dtype, i, x, use_reentrant=False)
             if remat else _block(model, cfg, dtype, i, x))
    x = layer_norm(x, model.final_g, model.final_b, cfg.norm_eps)
    if cfg.pool == "none":
        return x
    if cfg.pool == "cls":
        return x[:, 0]
    if mask is not None:
        w = mask.float()[..., None]
        pooled = torch.sum(x * w, dim=1) / torch.clamp_min(
            torch.sum(w, dim=1), 1.0)
    else:
        pooled = torch.mean(x, dim=1)
    return l2_normalize(pooled, dim=-1)
