"""Decoder-only transformer LM, dense path: GQA + RoPE + RMSNorm + SwiGLU,
ported from ``repro/models/transformer.py``.

Entry points:
  init_lm(cfg, seed, device)              random weights from a torch.Generator
  init_cache(cfg, batch, seq_len)         empty KV cache
  prefill(model, tokens)                  build the KV cache, last logits
  decode_step(model, token, cache)        one token through the cache

The reference stacks the layers along a leading axis and multiplies
``x @ W``; here each layer is an ``nn.Module`` of ``nn.Linear``s (weights
``[out, in]``; ``convert.lm_params_from_jax`` transposes). The large
matrix products stay ``F.linear``, as the reference leaves them to XLA.
Decode attention runs through ``kernels.ops.flash_decode`` (the hand
kernel on the card) or the dense plain path.

This slice serves fp32, dense-FFN, full-attention configurations; MoE,
the int8 KV cache and sliding-window attention raise
``NotImplementedError`` (ROADMAP.md §1, item 12).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.utils import resolve_device


def _check_supported(cfg: LMConfig) -> None:
    for what, unsupported in (("MoE", cfg.moe is not None),
                              ("kv_quant", cfg.kv_quant),
                              ("sliding-window attention",
                               cfg.sliding_window is not None)):
        if unsupported:
            raise NotImplementedError(
                f"{what} configs are not ported yet (ROADMAP.md §1 item 12)")


class Block(nn.Module):
    """One decoder layer's weights."""

    def __init__(self, cfg: LMConfig, device=None, dtype=torch.float32):
        super().__init__()
        D, H, KVH, Dh, Fh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.dh, cfg.d_ff)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.attn_norm = nn.Parameter(torch.empty(D, device=device,
                                                  dtype=dtype))
        self.ffn_norm = nn.Parameter(torch.empty(D, device=device,
                                                 dtype=dtype))
        self.wq = nn.Linear(D, H * Dh, **kw)
        self.wk = nn.Linear(D, KVH * Dh, **kw)
        self.wv = nn.Linear(D, KVH * Dh, **kw)
        self.wo = nn.Linear(H * Dh, D, **kw)
        self.w1 = nn.Linear(D, Fh, **kw)
        self.w3 = nn.Linear(D, Fh, **kw)
        self.w2 = nn.Linear(Fh, D, **kw)


class LM(nn.Module):
    def __init__(self, cfg: LMConfig, device=None, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        if dtype != torch.float32:
            raise NotImplementedError(
                "only fp32 weights are ported in this slice")
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model, device=device,
                                  dtype=dtype)
        self.layers = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, device=device,
                                                   dtype=dtype))
        self.out_head = (None if cfg.tie_embeddings else
                         nn.Linear(cfg.d_model, cfg.vocab, bias=False,
                                   device=device, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``init_lm`` scheme: N(0, 0.02) weights, output
        projections scaled by (2L)^-1/2, unit norms. Draws come from
        ``generator`` (same device as the weights)."""
        std_out = 0.02 / (2 * self.cfg.n_layers) ** 0.5
        self.embed.weight.normal_(0.0, 0.02, generator=generator)
        for blk in self.layers:
            blk.attn_norm.fill_(1.0)
            blk.ffn_norm.fill_(1.0)
            for lin in (blk.wq, blk.wk, blk.wv, blk.w1, blk.w3):
                lin.weight.normal_(0.0, 0.02, generator=generator)
            for lin in (blk.wo, blk.w2):
                lin.weight.normal_(0.0, std_out, generator=generator)
        self.final_norm.fill_(1.0)
        if self.out_head is not None:
            self.out_head.weight.normal_(0.0, 0.02, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device


def init_lm(cfg: LMConfig, seed: int = 0, device=None,
            dtype=torch.float32) -> LM:
    """A serving LM with random weights drawn on ``device`` (default cuda)
    from a ``torch.Generator`` seeded with ``seed``. The weights are
    allocated once, directly on the device."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta", dtype=dtype).to_empty(device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    model.requires_grad_(False)
    return model.eval()


# ---------------------------------------------------------------------------
# Layer pieces (shared by prefill / decode)
# ---------------------------------------------------------------------------
def _qkv(blk: Block, cfg: LMConfig, h: torch.Tensor, positions: torch.Tensor):
    """h [B,S,D] -> q [B,S,H,Dh], k,v [B,S,KVH,Dh] with RoPE applied."""
    B, S, _ = h.shape
    q = blk.wq(h).reshape(B, S, cfg.n_heads, cfg.dh)
    k = blk.wk(h).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    v = blk.wv(h).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(blk: Block, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, blk.ffn_norm, cfg.norm_eps)
    return x + blk.w2(F.silu(blk.w1(h)) * blk.w3(h))


def _head(model: LM, x: torch.Tensor) -> torch.Tensor:
    if model.out_head is None:
        return F.linear(x, model.embed.weight)
    return model.out_head(x)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Stacked-layer KV cache. k/v: [L, B, S_cache, KVH, Dh]; ``cur_len``
    [B] int32 is each serving slot's own position. ``decode_step`` writes
    the new token's K/V into ``k``/``v`` in place (the reference returns a
    new functional cache instead)."""
    k: torch.Tensor
    v: torch.Tensor
    cur_len: torch.Tensor


def init_cache(cfg: LMConfig, batch: int, seq_len: int,
               dtype=torch.float32, device=None) -> KVCache:
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   cur_len=torch.zeros(batch, dtype=torch.int32, device=dev))


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, max_len: int | None = None,
            prompt_lens: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt, build a cache with capacity ``max_len``, return the
    last-valid-position logits [B,1,V]. ``prompt_lens`` [B] supports
    right-padded batched prompts."""
    cfg = model.cfg
    B, S = tokens.shape
    Sc = max_len or S
    if Sc < S:
        raise ValueError(f"cache capacity {Sc} is shorter than the prompt {S}")
    dev = model.device
    tokens = tokens.to(dev).long()
    x = model.embed(tokens)
    positions = torch.arange(S, device=dev)[None, :]
    ks, vs = [], []
    for blk in model.layers:
        h = rms_norm(x, blk.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(blk, cfg, h, positions)
        attn = blocked_attention(q, k, v, causal=True,
                                 block_q=cfg.attn_block_q,
                                 block_k=cfg.attn_block_k)
        x = x + blk.wo(attn.reshape(B, S, -1))
        x = _ffn(blk, cfg, x)
        pad = (0, 0, 0, 0, 0, Sc - S)            # grow the seq dim to Sc
        ks.append(F.pad(k, pad))
        vs.append(F.pad(v, pad))
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if prompt_lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        x_last = x[:, -1:, :]
    else:
        lens = torch.as_tensor(prompt_lens, dtype=torch.int32).to(dev)
        idx = (lens.long() - 1).clamp(0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None, :]
    logits = _head(model, x_last)
    return logits, KVCache(k=torch.stack(ks), v=torch.stack(vs), cur_len=lens)


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cache: KVCache,
                attn_impl: str = "flash") -> tuple[torch.Tensor, KVCache]:
    """token [B,1] -> (logits [B,1,V], cache). One new token per sequence;
    every slot advances its own ``cur_len``.

    ``attn_impl``: "flash" (default) runs ``kernels.ops.flash_decode`` —
    the hand CUDA kernel for tensors on the card, its plain version on the
    CPU — once per layer, masking each slot at its own depth; "dense" is
    ``models.attention.decode_attention``. Both compute the same masked
    softmax attention in f32."""
    if attn_impl not in ("flash", "dense"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; "
                         "expected 'flash' or 'dense'")
    cfg = model.cfg
    dev = model.device
    B = token.shape[0]
    Sc = cache.k.shape[2]
    x = model.embed(token.to(dev).long())
    pos = cache.cur_len.to(torch.int32).expand(B)
    write_idx = (pos % Sc).long()
    positions = pos[:, None]
    b_idx = torch.arange(B, device=dev)
    n_valid = torch.minimum(pos + 1, torch.tensor(Sc, dtype=torch.int32,
                                                  device=dev))
    for li, blk in enumerate(model.layers):
        h = rms_norm(x, blk.attn_norm, cfg.norm_eps)
        q, k_new, v_new = _qkv(blk, cfg, h, positions)   # k_new [B,1,KVH,Dh]
        k_l, v_l = cache.k[li], cache.v[li]
        k_l[b_idx, write_idx] = k_new[:, 0].to(k_l.dtype)
        v_l[b_idx, write_idx] = v_new[:, 0].to(v_l.dtype)
        if attn_impl == "flash":
            a = ops.flash_decode(q[:, 0].contiguous(), k_l, v_l, n_valid)
            attn = a.to(x.dtype)[:, None]                # [B,1,H,Dh]
        else:
            attn = decode_attention(q, k_l, v_l, n_valid)
        x = x + blk.wo(attn.reshape(B, 1, -1))
        x = _ffn(blk, cfg, x)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(model, x)
    return logits, KVCache(k=cache.k, v=cache.v, cur_len=pos + 1)
