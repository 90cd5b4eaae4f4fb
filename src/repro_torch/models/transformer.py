"""Decoder-only transformer LM: GQA + RoPE + RMSNorm + SwiGLU (+ sliding-
window attention, + MoE, + an int8 KV cache), ported from
``repro/models/transformer.py``.

Entry points:
  init_lm(cfg, seed, device, dtype)       random weights from a torch.Generator
  lm_param_axes(cfg)                      logical sharding axes by leaf name
  lm_loss(model, tokens, labels, dtype=)  training loss (full or chunked vocab)
  init_cache(cfg, batch, seq_len, dtype)  empty KV cache (a ring under SWA)
  prefill(model, tokens, dtype=)          build the KV cache, last logits
  decode_step(model, token, cache, dtype=)  one token through the cache

The reference stacks the layers along a leading axis and multiplies
``x @ W``; here each layer is an ``nn.Module`` of ``nn.Linear``s (weights
``[out, in]``; ``convert.lm_params_from_jax`` transposes), and an MoE
layer's ``models.moe.MoE`` keeps the reference's layout. The large
matrix products stay ``F.linear``/``bmm``, as the reference leaves them
to XLA. Decode attention runs through ``kernels.ops.flash_decode`` (the
hand kernel on the card) or the dense plain path.

Sliding-window configs keep a ring of ``cache_len`` = min(seq_len,
window) positions, position p at slot p % Sc. Under ``cfg.kv_quant`` the
cache holds int8 payloads with an fp32 scale a (layer, row, position,
KV head), dequantized a layer at a time before the attention.

Weights are fp32, bf16 or fp16. ``prefill`` and ``decode_step`` compute
at ``dtype`` as the reference does: each weight cast to it where it is
used (a no-op when it already is), activations and the cache in it; the
products sum in fp32 (``models.common``) and are cast to
``dtype`` where the reference casts them, while the dense FFN's h1, h3
and silu(h1)·h3, the MoE's expert products and combine, and the head's
logits stay fp32 as there. The reference defaults ``dtype`` to bf16; the
port's ``dtype=None`` is the weights' own, so an fp32 model computes in
fp32 unless asked.

Training (``lm_loss``, ``forward_hidden``) runs each layer through the
body ``prefill`` uses, on the whole sequence, and keeps the MoE's aux
loss. Under ``cfg.remat`` (the default) each layer runs under
``torch.utils.checkpoint`` and its activations are recomputed in the
backward, as the reference's ``jax.checkpoint``; ``cfg.chunked_loss``
computes the vocab loss a sequence chunk at a time, each chunk
checkpointed. At a compute dtype other than the weights', the whole
parameter tree is cast once at entry (``cast_params_for_compute``, the
reference's), norms and router included. ``cfg.scan_layers`` changes
nothing here: the layers are a Python loop either way.
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import (
    blocked_attention,
    decode_attention,
    swa_blocked_attention,
)
from repro_torch.models.common import (
    apply_rope,
    linear,
    linear_f32,
    rms_norm,
    softmax_xent,
    weight,
)
from repro_torch.models.moe import MoE, moe_ffn, moe_layer_axes
from repro_torch.utils import generator, resolve_device


class Block(nn.Module):
    """One decoder layer's weights: the dense FFN's ``w1``/``w3``/``w2``,
    or ``moe`` for an MoE config."""

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
        if cfg.moe is not None:
            self.moe = MoE(D, cfg.moe, device=device, dtype=dtype)
        else:
            self.w1 = nn.Linear(D, Fh, **kw)
            self.w3 = nn.Linear(D, Fh, **kw)
            self.w2 = nn.Linear(Fh, D, **kw)


WEIGHT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class LM(nn.Module):
    def __init__(self, cfg: LMConfig, device=None, dtype=torch.float32):
        super().__init__()
        if dtype not in WEIGHT_DTYPES:
            raise ValueError(f"LM weights are fp32, bf16 or fp16, not {dtype}")
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
        projections scaled by (2L)^-1/2, unit norms; MoE layers by
        ``init_moe_layer``'s. Draws come from ``generator`` (same device
        as the weights)."""
        L = self.cfg.n_layers
        std_out = 0.02 / (2 * L) ** 0.5
        self.embed.weight.normal_(0.0, 0.02, generator=generator)
        for blk in self.layers:
            blk.attn_norm.fill_(1.0)
            blk.ffn_norm.fill_(1.0)
            dense = self.cfg.moe is None
            for lin in (blk.wq, blk.wk, blk.wv) + (
                    (blk.w1, blk.w3) if dense else ()):
                lin.weight.normal_(0.0, 0.02, generator=generator)
            for lin in (blk.wo,) + ((blk.w2,) if dense else ()):
                lin.weight.normal_(0.0, std_out, generator=generator)
            if not dense:
                blk.moe.reset_parameters(generator, L)
        self.final_norm.fill_(1.0)
        if self.out_head is not None:
            self.out_head.weight.normal_(0.0, 0.02, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The weights' dtype (the default compute dtype)."""
        return self.embed.weight.dtype


def init_lm(cfg: LMConfig, seed: int = 0, device=None,
            dtype=torch.float32) -> LM:
    """A serving LM with random weights drawn on ``device`` (default cuda)
    from a ``torch.Generator`` seeded with ``seed``. The weights are
    allocated once, directly on the device, and frozen; a train step
    (``train.train_loop.make_train_step``) enables the gradients of what
    it trains."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta", dtype=dtype).to_empty(device=dev)
    model.reset_parameters(generator(seed, dev))
    model.requires_grad_(False)
    return model.eval()


# the reference's axes of the stacked leaves [L, in, out], less "layers"
# and transposed to nn.Linear's [out, in]
_LINEAR_AXES = {"wq": ("heads", "embed"), "wk": ("kv_heads", "embed"),
                "wv": ("kv_heads", "embed"), "wo": ("embed", "heads"),
                "w1": ("mlp", "embed"), "w3": ("mlp", "embed"),
                "w2": ("embed", "mlp")}


def lm_param_axes(cfg: LMConfig) -> dict[str, tuple]:
    """Logical sharding axes keyed as ``LM``'s parameters: the
    reference's, without its ``layers`` axis (one module a layer here)
    and transposed where ``nn.Linear`` holds a weight as [out, in]; an
    MoE layer's weights keep the reference's layout (``moe_layer_axes``)."""
    axes = {"embed.weight": ("vocab", "embed"), "final_norm": ("embed",)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        axes[pre + "attn_norm"] = ("embed",)
        axes[pre + "ffn_norm"] = ("embed",)
        names = ("wq", "wk", "wv", "wo") + (
            () if cfg.moe is not None else ("w1", "w3", "w2"))
        axes.update({f"{pre}{n}.weight": _LINEAR_AXES[n] for n in names})
        if cfg.moe is not None:
            axes.update({f"{pre}moe.{n}": a
                         for n, a in moe_layer_axes().items()})
    if not cfg.tie_embeddings:
        axes["out_head.weight"] = ("vocab", "embed")
    return axes


# ---------------------------------------------------------------------------
# Layer pieces (shared by train / prefill / decode)
# ---------------------------------------------------------------------------
def _proj(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` at ``x``'s dtype: the weight cast to it, the product
    summed in fp32 and rounded to x's dtype once (the reference's einsum,
    then astype)."""
    return linear(x, weight(lin.weight, x.dtype))


def _qkv(blk: Block, cfg: LMConfig, h: torch.Tensor, positions: torch.Tensor):
    """h [B,S,D] -> q [B,S,H,Dh], k,v [B,S,KVH,Dh] with RoPE applied."""
    B, S, _ = h.shape
    q = _proj(blk.wq, h).reshape(B, S, cfg.n_heads, cfg.dh)
    k = _proj(blk.wk, h).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    v = _proj(blk.wv, h).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(blk: Block, cfg: LMConfig, x: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The FFN residual and the MoE's aux loss (None for the dense FFN,
    where the reference's is a zero). The dense FFN keeps h1, h3 and
    silu(h1)·h3 in fp32 and casts once."""
    h = rms_norm(x, blk.ffn_norm, cfg.norm_eps)
    if cfg.moe is not None:
        B, S, D = h.shape
        out, aux = moe_ffn(blk.moe, cfg.moe, h.reshape(B * S, D))
        return x + out.reshape(B, S, D), aux
    dt = h.dtype
    g = F.silu(linear_f32(h, weight(blk.w1.weight, dt))) \
        * linear_f32(h, weight(blk.w3.weight, dt))
    return x + _proj(blk.w2, g.to(dt)), None


def _layer(blk: Block, cfg: LMConfig, x: torch.Tensor,
           positions: torch.Tensor, impl: str = "masked"):
    """One decoder layer on a full sequence x [B,S,D] -> (x, aux, k, v):
    the MoE aux loss (or None) and the layer's K/V [B,S,KVH,Dh] after
    RoPE. Sliding-window configs take the reference's banded attention
    (its kv block is ``attn_block_q``)."""
    B, S, _ = x.shape
    h = rms_norm(x, blk.attn_norm, cfg.norm_eps)
    q, k, v = _qkv(blk, cfg, h, positions)
    if cfg.sliding_window is not None:
        attn = swa_blocked_attention(q, k, v, window=cfg.sliding_window,
                                     block_q=cfg.attn_block_q,
                                     block_k=cfg.attn_block_q)
    else:
        attn = blocked_attention(q, k, v, causal=True, impl=impl,
                                 block_q=cfg.attn_block_q,
                                 block_k=cfg.attn_block_k)
    x = x + _proj(blk.wo, attn.reshape(B, S, -1))
    x, aux = _ffn(blk, cfg, x)
    return x, aux, k, v


def _train_layer(cfg: LMConfig, impl: str, blk: Block, x: torch.Tensor):
    """One decoder layer on a full sequence (no cache) -> (x, aux)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux, _, _ = _layer(blk, cfg, x, positions, impl)
    return x, aux


def stack_layers(model: LM) -> dict[str, torch.Tensor]:
    """The layers' weights stacked along a leading [L] axis, keyed as a
    ``Block``'s parameters (the stage parameters of
    ``distributed.pipeline.pipeline_apply``)."""
    names = [n for n, _ in model.layers[0].named_parameters()]
    return {n: torch.stack([dict(blk.named_parameters())[n].detach()
                            for blk in model.layers]) for n in names}


def layer_stage(cfg: LMConfig, impl: str = "masked"):
    """A pipeline stage of one decoder layer: ``stage(p, x)`` runs
    ``_train_layer`` on x [B,S,D] with the weights ``p`` (one layer's
    slice of ``stack_layers``), through which gradients flow; the MoE aux
    loss is dropped."""
    template = Block(cfg, device="meta")
    params = list(template.named_parameters())

    def stage(p: dict, x: torch.Tensor) -> torch.Tensor:
        blk = copy.deepcopy(template, {id(t): p[n] for n, t in params})
        return _train_layer(cfg, impl, blk, x)[0]

    return stage


def _embed(model: LM, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The embedding rows of ``tokens``, taken, then cast to ``dtype``."""
    return model.embed(tokens).to(dtype)


def _head_weight(model: LM, dtype) -> torch.Tensor:
    """The vocab projection [V, D] (the tied embedding or ``out_head``)
    in ``dtype``."""
    w = model.embed.weight if model.out_head is None else model.out_head.weight
    return weight(w, dtype)


def _head(model: LM, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 from ``x`` at its dtype (never cast back)."""
    return linear_f32(x, _head_weight(model, x.dtype))


# ---------------------------------------------------------------------------
# Full forward / loss (training)
# ---------------------------------------------------------------------------
def cast_params_for_compute(model: LM, dtype) -> LM:
    """The model with every parameter cast to ``dtype`` once (the
    reference's step-entry cast): itself when ``dtype`` is None or the
    weights' own, else a structural copy holding the casts, through which
    gradients reach the original parameters."""
    if dtype is None or model.dtype == dtype:
        return model
    memo = {id(p): p.to(dtype) for p in model.parameters()}
    return copy.deepcopy(model, memo)


def forward_hidden(model: LM, tokens: torch.Tensor, dtype=None,
                   impl: str = "masked"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B,S] -> (final hidden states [B,S,D] at the compute
    dtype, the MoE aux loss summed over layers, an fp32 scalar).
    ``dtype``: the compute dtype (default the weights')."""
    model = cast_params_for_compute(model, dtype)
    cfg = model.cfg
    x = _embed(model, tokens.to(model.device).long(), model.dtype)
    aux = torch.zeros((), device=x.device)
    for blk in model.layers:
        if cfg.remat:
            x, a = checkpoint(_train_layer, cfg, impl, blk, x,
                              use_reentrant=False)
        else:
            x, a = _train_layer(cfg, impl, blk, x)
        if a is not None:
            aux = aux + a
    return rms_norm(x, model.final_norm, cfg.norm_eps), aux


def _chunk_nll(x_c: torch.Tensor, y_c: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one sequence chunk's fp32 logits."""
    logits = linear_f32(x_c, w)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y_c[..., None])[..., 0]
    return torch.sum(lse - ll)


def lm_loss(model: LM, tokens: torch.Tensor, labels: torch.Tensor,
            dtype=None, impl: str = "masked") -> torch.Tensor:
    """Causal LM loss (mean NLL plus the MoE aux loss), an fp32 scalar.
    ``cfg.chunked_loss`` > 0 computes the vocab projection a sequence
    chunk at a time under ``checkpoint``: the [B,S,V] logits are never
    held. ``dtype``: the compute dtype (default the weights')."""
    model = cast_params_for_compute(model, dtype)
    cfg = model.cfg
    x, aux = forward_hidden(model, tokens, impl=impl)
    labels = labels.to(x.device).long()
    if cfg.chunked_loss <= 0:
        return softmax_xent(_head(model, x), labels) + aux
    B, S, _ = x.shape
    cs = min(cfg.chunked_loss, S)
    if S % cs:
        raise ValueError(f"chunked_loss {cs} does not divide S {S}")
    w = _head_weight(model, x.dtype)
    tot = torch.zeros((), device=x.device)
    for i in range(S // cs):
        sl = slice(i * cs, (i + 1) * cs)
        tot = tot + checkpoint(_chunk_nll, x[:, sl], labels[:, sl], w,
                               use_reentrant=False)
    return tot / torch.tensor(float(B * S), device=x.device) + aux


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Stacked-layer KV cache. k/v: [L, B, S_cache, KVH, Dh]; ``cur_len``
    [B] int32 is each serving slot's own position. With ``cfg.kv_quant``
    k/v are int8 and ``k_scale``/``v_scale`` [L, B, S_cache, KVH] hold the
    fp32 scales. ``decode_step`` writes the new token's K/V into the
    tensors in place (the reference returns a new functional cache)."""
    k: torch.Tensor
    v: torch.Tensor
    cur_len: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 payload, fp32 scale [...]); rounds half to
    even, as ``jnp.round``. Both divisions are tensor by tensor: PyTorch
    on the card turns a division by a Python scalar into a product with
    its reciprocal, which can differ in the last bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0) + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def cache_len(cfg: LMConfig, seq_len: int) -> int:
    """SWA configs keep a ring of the window; full attention keeps S."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: LMConfig, batch: int, seq_len: int,
               dtype=torch.float32, device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len(cfg, seq_len), cfg.n_kv_heads,
             cfg.dh)
    pay = torch.int8 if cfg.kv_quant else dtype
    ks = vs = None
    if cfg.kv_quant:
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    return KVCache(k=torch.zeros(shape, dtype=pay, device=dev),
                   v=torch.zeros(shape, dtype=pay, device=dev),
                   cur_len=torch.zeros(batch, dtype=torch.int32, device=dev),
                   k_scale=ks, v_scale=vs)


def _ring(x: torch.Tensor, Sc: int) -> torch.Tensor:
    """A prompt's K or V [B, S, KVH, Dh] in the cache layout (position p
    at slot p % Sc): the last Sc positions rolled when the ring is shorter
    than the prompt, zero padding to Sc when it is longer."""
    S = x.shape[1]
    if Sc < S:
        return torch.roll(x[:, S - Sc:], S % Sc, dims=1)
    if Sc > S:
        return F.pad(x, (0, 0, 0, 0, 0, Sc - S))
    return x


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, max_len: int | None = None,
            prompt_lens: torch.Tensor | None = None, dtype=None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt, build a cache with capacity ``max_len`` (a ring of
    ``cache_len`` under SWA), return the last-valid-position logits
    [B,1,V] fp32. ``prompt_lens`` [B] supports right-padded batched
    prompts. ``dtype``: the compute dtype (default the weights'); the
    cache holds K/V in it (int8 under ``kv_quant``)."""
    cfg = model.cfg
    B, S = tokens.shape
    Sc = cache_len(cfg, max_len or S)
    dev = model.device
    tokens = tokens.to(dev).long()
    x = _embed(model, tokens, dtype or model.dtype)
    positions = torch.arange(S, device=dev)[None, :]
    ks, vs, kss, vss = [], [], [], []
    for blk in model.layers:
        x, _, k, v = _layer(blk, cfg, x, positions)
        k, v = _ring(k, Sc), _ring(v, Sc)
        if cfg.kv_quant:
            (k, k_s), (v, v_s) = _quantize_kv(k), _quantize_kv(v)
            kss.append(k_s)
            vss.append(v_s)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if prompt_lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        x_last = x[:, -1:, :]
    else:
        lens = torch.as_tensor(prompt_lens, dtype=torch.int32).to(dev)
        idx = (lens.long() - 1).clamp(0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None, :]
    logits = _head(model, x_last)
    scales = ((torch.stack(kss), torch.stack(vss)) if cfg.kv_quant
              else (None, None))
    return logits, KVCache(torch.stack(ks), torch.stack(vs), lens, *scales)


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cache: KVCache,
                attn_impl: str = "flash", dtype=None
                ) -> tuple[torch.Tensor, KVCache]:
    """token [B,1] -> (logits [B,1,V] fp32, cache). One new token per
    sequence; every slot advances its own ``cur_len``. ``dtype``: the
    compute dtype (default the weights').

    ``attn_impl``: "flash" (default) runs ``kernels.ops.flash_decode`` —
    the hand CUDA kernel for tensors on the card, its plain version on the
    CPU — once per layer, masking each slot at its own depth; "dense" is
    ``models.attention.decode_attention``. Both compute the same masked
    softmax attention in f32. The new token's K/V go to slot pos % Sc (a
    full SWA ring is all valid: the oldest position is overwritten), and
    under ``kv_quant`` they are quantized there and the layer's cache is
    dequantized to the compute dtype before the attention. A cache of
    another float dtype than the compute dtype is attended with both
    widened to fp32, as the reference's kernel upcasts them (the hand
    kernel takes one dtype)."""
    if attn_impl not in ("flash", "dense"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; "
                         "expected 'flash' or 'dense'")
    cfg = model.cfg
    dev = model.device
    B = token.shape[0]
    Sc = cache.k.shape[2]
    x = _embed(model, token.to(dev).long(), dtype or model.dtype)
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
        if cfg.kv_quant:
            ks_l, vs_l = cache.k_scale[li], cache.v_scale[li]
            (kq, k_s), (vq, v_s) = (_quantize_kv(k_new[:, 0]),
                                    _quantize_kv(v_new[:, 0]))
            k_l[b_idx, write_idx] = kq
            v_l[b_idx, write_idx] = vq
            ks_l[b_idx, write_idx] = k_s
            vs_l[b_idx, write_idx] = v_s
            k_att = _dequantize_kv(k_l, ks_l, x.dtype)
            v_att = _dequantize_kv(v_l, vs_l, x.dtype)
        else:
            k_l[b_idx, write_idx] = k_new[:, 0].to(k_l.dtype)
            v_l[b_idx, write_idx] = v_new[:, 0].to(v_l.dtype)
            k_att, v_att = k_l, v_l
        if attn_impl == "flash":
            qa = q[:, 0].contiguous()
            if k_att.dtype != qa.dtype:
                qa, k_att, v_att = qa.float(), k_att.float(), v_att.float()
            a = ops.flash_decode(qa, k_att, v_att, n_valid)
            attn = a.to(x.dtype)[:, None]                # [B,1,H,Dh]
        else:
            attn = decode_attention(q, k_att, v_att, n_valid)
        x = x + _proj(blk.wo, attn.reshape(B, 1, -1))
        x, _ = _ffn(blk, cfg, x)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(model, x)
    return logits, KVCache(cache.k, cache.v, pos + 1, cache.k_scale,
                           cache.v_scale)
