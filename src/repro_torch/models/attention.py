"""Blocked (flash-style) attention as plain torch ops, GQA-aware — the
prefill path and the dense decode path of ``repro/models/attention.py``.

  * ``blocked_attention`` — training and prefill: a loop over (q block,
    kv block) with a running log-sum-exp. ``impl="masked"`` (what the
    reference's prefill uses) computes the rectangle with causal
    masking, up to the diagonal: a kv block wholly above it would merge
    as an exact no-op (scale 1, add 0), so the loop stops there and the
    result is the full rectangle's bit for bit; ``impl="packed"`` pairs
    the q-block rows ``i`` and ``nb-1-i`` so that every step merges
    ``nb + 1`` causal kv blocks and no block wholly above the diagonal. This is plain tensor code in the reference
    too, not a Pallas kernel, so the port keeps the same math rather than
    calling a library attention.
  * ``swa_blocked_attention`` — causal sliding-window attention: each q
    block scores only the in-band kv span (``window + block_q`` positions,
    block-aligned), the prefill of sliding-window configs.
  * ``decode_attention`` — one new token against the KV cache; direct
    reduction, f32 accumulation (``decode_step(attn_impl="dense")``).
  * ``reference_attention`` — the O(S^2)-memory oracle of the tests.

All products accumulate in float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def pick_block(s: int, b: int) -> int:
    """Largest divisor of ``s`` that is <= ``b``."""
    b = min(b, s)
    while s % b != 0:
        b -= 1
    return max(b, 1)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,bq,H,Dh], k [B,bk,KVH,Dh] -> scores [B,H,bq,bk] (f32)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    return s.reshape(b, h, sq, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,H,bq,bk] (f32), v [B,bk,KVH,Dh] -> [B,bq,H,Dh] (f32)."""
    b, h, sq, sk = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, h // kvh, sq, sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v.float())
    return o.reshape(b, sq, h, v.shape[-1])


def _merge_block(carry, scores, v_blk, block_mask):
    """Online-softmax merge of one kv block. carry = (m, l, acc) in f32:
    m [B,H,bq], l [B,H,bq], acc [B,bq,H,Dh]."""
    m, l, acc = carry
    scores = torch.where(block_mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)  # fully-masked guard
    p = torch.where(block_mask, torch.exp(scores - m_safe[..., None]), 0.0)
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None].transpose(1, 2) + _gqa_values(p, v_blk)
    return m_new, l_new, acc_new


def _finalize(l, acc, dtype):
    return (acc / l.clamp_min(1e-30)[..., None].transpose(1, 2)).to(dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block_q: int = 512,
                      block_k: int = 1024,
                      impl: str = "masked") -> torch.Tensor:
    """Flash-style attention. q [B,S,H,Dh]; k,v [B,Sk,KVH,Dh] -> [B,S,H,Dh].
    ``impl="packed"`` takes the packed causal schedule where the
    reference does (causal, Sq == Sk, equal blocks, an even block count)
    and the masked rectangle otherwise."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    block_q = pick_block(sq, block_q)
    block_k = pick_block(sk, block_k)
    if (impl == "packed" and causal and sq == sk and block_q == block_k
            and (sq // block_q) % 2 == 0):
        return _packed_causal_attention(q, k, v, blk=block_q)
    sm_scale = dh ** -0.5
    dev = q.device
    pos_q = torch.arange(sq, device=dev)
    pos_k = torch.arange(sk, device=dev)
    outs = []
    for iq in range(sq // block_q):
        q_i = q[:, iq * block_q:(iq + 1) * block_q] * sm_scale
        q_pos = pos_q[iq * block_q:(iq + 1) * block_q]
        carry = (torch.full((b, h, block_q), NEG_INF, device=dev),
                 torch.zeros((b, h, block_q), device=dev),
                 torch.zeros((b, block_q, h, dh), device=dev))
        for jk in range(sk // block_k):
            if causal and jk * block_k > (iq + 1) * block_q - 1:
                # every later kv block lies wholly above the diagonal: its
                # merge would scale by exactly 1 and add exactly 0
                break
            k_j = k[:, jk * block_k:(jk + 1) * block_k]
            v_j = v[:, jk * block_k:(jk + 1) * block_k]
            scores = _gqa_scores(q_i, k_j)                     # [B,H,bq,bk]
            if causal:
                k_pos = pos_k[jk * block_k:(jk + 1) * block_k]
                mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
            else:
                mask = torch.ones((1, 1, block_q, block_k), dtype=torch.bool,
                                  device=dev)
            carry = _merge_block(carry, scores, v_j, mask)
        outs.append(_finalize(carry[1], carry[2], q.dtype))
    return torch.cat(outs, dim=1)


def _packed_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, blk: int) -> torch.Tensor:
    """Causal attention with the lower triangle packed onto a rectangle:
    q-block row ``i`` (which needs kv blocks 0..i) is paired with row
    ``nb-1-i`` (kv blocks 0..nb-1-i), ``nb + 1`` kv-block merges a pair,
    each in the reference's slot order (row i's blocks first)."""
    b, s, h, dh = q.shape
    nb = s // blk
    sm_scale = dh ** -0.5
    dev = q.device
    out = [None] * nb
    for i in range(nb // 2):
        carries = {}
        for row in (i, nb - 1 - i):
            carries[row] = (torch.full((b, h, blk), NEG_INF, device=dev),
                            torch.zeros((b, h, blk), device=dev),
                            torch.zeros((b, blk, h, dh), device=dev))
        for slot in range(nb + 1):
            row, kv = (i, slot) if slot <= i else (nb - 1 - i, slot - i - 1)
            q_i = q[:, row * blk:(row + 1) * blk] * sm_scale
            sl = slice(kv * blk, (kv + 1) * blk)
            q_pos = row * blk + torch.arange(blk, device=dev)
            k_pos = kv * blk + torch.arange(blk, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
            carries[row] = _merge_block(carries[row],
                                        _gqa_scores(q_i, k[:, sl]),
                                        v[:, sl], mask)
        for row, (_, l, acc) in carries.items():
            out[row] = _finalize(l, acc, q.dtype)
    return torch.cat(out, dim=1)


def swa_blocked_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, window: int,
                          block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    """Causal sliding-window attention (position p sees keys in (p - window,
    p]); touches only in-band kv blocks. q [B,S,H,Dh]; k,v [B,Sk,KVH,Dh]."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    block_q = pick_block(sq, block_q)
    block_k = pick_block(sk, block_k)
    if sk <= window:          # the window covers every prefix: plain causal
        return blocked_attention(q, k, v, causal=True, block_q=block_q,
                                 block_k=block_k)
    # kv span one q block needs: window + block_q positions, block-aligned
    span = min(((window + block_q) // block_k + 1) * block_k, sk)
    sm_scale = dh ** -0.5
    dev = q.device
    outs = []
    for iq in range(sq // block_q):
        q_lo = iq * block_q
        q_i = q[:, q_lo:q_lo + block_q] * sm_scale
        start = min(max(q_lo + block_q - span, 0), sk - span)
        scores = _gqa_scores(q_i, k[:, start:start + span])  # [B,H,bq,span]
        q_pos = q_lo + torch.arange(block_q, device=dev)
        k_pos = start + torch.arange(span, device=dev)
        mask = ((q_pos[:, None] >= k_pos[None, :])
                & (k_pos[None, :] > q_pos[:, None] - window))
        scores = torch.where(mask[None, None], scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1, keepdim=True)
        out = _gqa_values(p / l.clamp_min(1e-30), v[:, start:start + span])
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention against the cache. q [B,1,H,Dh]; k_cache/v_cache
    [B,S,KVH,Dh]; ``cur_len`` scalar or per-sequence [B] -> [B,1,H,Dh].
    ``window`` also masks positions below ``cur_len - window``."""
    b, _, h, dh = q.shape
    s = k_cache.shape[1]
    scores = _gqa_scores(q * dh ** -0.5, k_cache)          # [B,H,1,S]
    pos = torch.arange(s, device=q.device)
    cur = torch.as_tensor(cur_len, dtype=torch.int32,
                          device=q.device).reshape(-1).expand(b)
    valid = pos[None, :] < cur[:, None]                    # [B,S]
    if window is not None:
        valid &= pos[None, :] >= cur[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return _gqa_values(p, v_cache).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """O(S^2)-memory oracle for tests; the queries are the last Sq
    positions of the Sk keys."""
    sq, dh = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scores = _gqa_scores(q * dh ** -0.5, k)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    return _gqa_values(torch.softmax(scores, dim=-1), v).to(q.dtype)
