"""Port parity for the attention functions of ``models/attention.py``
(CPU): sliding-window prefill, the windowed dense decode and the
oracle, against ``repro.models.attention`` on the same seeded inputs.

Tolerance: 1e-5 (fp32 products summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn


def _qkv(seed, b, s, h, kvh, dh, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, dh)).astype(np.float32))


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


# the reference's own cases (tests/test_attention.py: s, window, block),
# the last one a window that covers every prefix
SWA_CASES = [(64, 24, 16), (96, 32, 16), (128, 16, 32), (64, 64, 16)]


@pytest.mark.parametrize("s,w,bq", SWA_CASES)
def test_swa_blocked_attention_matches_reference(s, w, bq):
    arrays = _qkv(2, 2, s, 4, 2, 8)
    got, want = _both(jattn.swa_blocked_attention,
                      tattn.swa_blocked_attention, arrays, window=w,
                      block_q=bq, block_k=bq)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and the port's oracle
    oracle = tattn.reference_attention(*map(torch.from_numpy, arrays),
                                       causal=True, window=w).numpy()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,w,causal", [(64, 24, True), (96, 32, True),
                                        (40, None, True), (40, 8, False),
                                        (33, None, False)])
def test_reference_attention_matches_reference(s, w, causal):
    arrays = _qkv(3, 2, s, 4, 2, 8)
    got, want = _both(jattn.reference_attention, tattn.reference_attention,
                      arrays, causal=causal, window=w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reference_attention_queries_are_the_last_positions():
    """Sq < Sk: the queries stand at the last Sq key positions."""
    arrays = _qkv(4, 2, 5, 4, 2, 8, sk=21)
    got, want = _both(jattn.reference_attention, tattn.reference_attention,
                      arrays, causal=True, window=6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [None, 1, 5, 40])
def test_decode_attention_window_matches_reference(window):
    q, k, v = _qkv(5, 4, 1, 4, 2, 8, sk=32)
    cur = np.array([3, 10, 32, 1], np.int32)
    got, want = _both(jattn.decode_attention, tattn.decode_attention,
                      (q, k, v, cur), window=window)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _full_rectangle(q, k, v, blk):
    """``blocked_attention``'s masked loop over every (q block, kv block),
    the blocks above the diagonal included."""
    b, s, h, dh = q.shape
    outs = []
    for iq in range(s // blk):
        q_i = q[:, iq * blk:(iq + 1) * blk] * dh ** -0.5
        q_pos = iq * blk + torch.arange(blk)
        carry = (torch.full((b, h, blk), tattn.NEG_INF),
                 torch.zeros((b, h, blk)), torch.zeros((b, blk, h, dh)))
        for jk in range(s // blk):
            sl = slice(jk * blk, (jk + 1) * blk)
            mask = (q_pos[:, None] >= jk * blk + torch.arange(blk)[None])
            carry = tattn._merge_block(carry, tattn._gqa_scores(q_i, k[:, sl]),
                                       v[:, sl], mask[None, None])
        outs.append(tattn._finalize(carry[1], carry[2], q.dtype))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("s,bq", [(61, 16), (64, 16), (40, 16), (33, 16)])
def test_causal_blocked_attention_skips_blocks_bit_for_bit(s, bq):
    """The causal loop stops at the diagonal: output and gradients equal
    the full rectangle's bit for bit (61, a prime, runs blocks of 1, as
    the served engine's prefill of 127 positions at max_len 128 does)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(5, 2, s, 4, 2, 16))
    outs = []
    for fn in (lambda: tattn.blocked_attention(q, k, v, causal=True,
                                               block_q=bq, block_k=bq),
               lambda: _full_rectangle(q, k, v, tattn.pick_block(s, bq))):
        o = fn()
        outs.append((o, torch.autograd.grad((o ** 2).sum(), (q, k, v))))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
