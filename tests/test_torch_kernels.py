"""Port parity for the kernel layer: every plain PyTorch version in
``repro_torch/kernels/ref.py`` against its jnp oracle in
``repro/kernels/ref.py``, on the same numpy inputs (CPU). The oracles are
what ``repro.kernels.ops`` runs off-TPU, and ``tests/test_kernels.py``
pins them to the Pallas kernels in interpret mode.

Tolerances: fp32 distances and attention outputs differ only by the two
frameworks' summation order (rtol 1e-5 / atol 1e-6 for gather_distance,
atol 1e-5 elsewhere). Ids are compared exactly on integer-valued l2/ip
inputs, whose dot products are exact in fp32 in both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# gather_distance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_gather_distance_ref_matches_jax(metric):
    rng = np.random.default_rng(1)
    vec = rng.normal(size=(200, 24)).astype(np.float32)
    if metric == "cosine":
        vec = _unit(vec)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    ids = rng.integers(0, 200, size=(7, 11)).astype(np.int32)
    want = np.asarray(jref.gather_distance_ref(
        jnp.asarray(vec), jnp.asarray(q), jnp.asarray(ids), metric=metric))
    got = tref.gather_distance_ref(_t(vec), _t(q), _t(ids), metric=metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ops_cpu_tensors_take_the_plain_version_uncounted():
    """CPU tensors dispatch to ref and never bump a kernel counter."""
    rng = np.random.default_rng(2)
    vec = _t(rng.normal(size=(50, 8)).astype(np.float32))
    q = _t(rng.normal(size=(3, 8)).astype(np.float32))
    ids = _t(rng.integers(0, 50, size=(3, 5)).astype(np.int32))
    dispatch.reset()
    out = tops.gather_distance(vec, q, ids, metric="l2")
    torch.testing.assert_close(out, tref.gather_distance_ref(
        vec, q, ids, metric="l2"), rtol=0, atol=0)
    qk = _t(rng.normal(size=(2, 4, 8)).astype(np.float32))
    kv = _t(rng.normal(size=(2, 6, 2, 8)).astype(np.float32))
    tops.flash_decode(qk, kv, kv, 3)
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)
    with pytest.raises(ValueError, match="unknown metric"):
        tops.gather_distance(vec, q, ids, metric="hamming")


# ---------------------------------------------------------------------------
# beam helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t_live,t", [(4, 4), (2, 4), (1, 1)])
def test_beam_select_frontier_matches_jax(t_live, t):
    rng = np.random.default_rng(5)
    b, efp = 5, 16
    bd = np.sort(rng.random((b, efp)).astype(np.float32), axis=-1)
    bi = rng.permutation(b * efp).reshape(b, efp).astype(np.int32)
    bi[:, 12:] = -1
    bx = rng.random((b, efp)) < 0.4
    jx, jn = jref.beam_select_frontier(jnp.asarray(bd), jnp.asarray(bi),
                                       jnp.asarray(bx), t_live, t)
    tx, tn = tref.beam_select_frontier(_t(bd), _t(bi), _t(bx), t_live, t)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_beam_dedup_valid_matches_jax():
    rng = np.random.default_rng(6)
    cand = rng.integers(0, 20, size=(4, 24)).astype(np.int32)
    valid = rng.random((4, 24)) < 0.8
    bi = rng.integers(-1, 20, size=(4, 8)).astype(np.int32)
    want = jref.beam_dedup_valid(jnp.asarray(cand), jnp.asarray(valid),
                                 jnp.asarray(bi))
    got = tref.beam_dedup_valid(_t(cand), _t(valid), _t(bi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_bitonic", [True, False])
def test_beam_merge_matches_jax(use_bitonic):
    """The port's sorted merge equals the JAX oracle's, by its bitonic
    network and by its sort."""
    rng = np.random.default_rng(7)
    b, efp, w, ef = 3, 16, 24, 12
    ids = rng.permutation(200)[: b * (efp + w)].reshape(b, efp + w)
    ids = ids.astype(np.int32)
    bd = np.sort(rng.random((b, efp)).astype(np.float32), axis=-1)
    bi = ids[:, :efp].copy()
    bd[:, ef:], bi[:, ef:] = jref.BEAM_INF, -1
    bx = rng.random((b, efp)) < 0.5
    cd = rng.random((b, w)).astype(np.float32)
    ci = ids[:, efp:].copy()
    drop = rng.random((b, w)) < 0.3
    cd[drop], ci[drop] = jref.BEAM_INF, -1
    merge = jax.jit(jref.beam_merge, static_argnums=(5, 6))
    want = merge(jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(bx),
                 jnp.asarray(cd), jnp.asarray(ci), ef, use_bitonic)
    got = tref.beam_merge(_t(bd), _t(bi), _t(bx), _t(cd), _t(ci), ef)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    live = np.asarray(want[1]) >= 0          # pads' expanded bit is unread
    np.testing.assert_array_equal(got[2].numpy()[live],
                                  np.asarray(want[2])[live])


# ---------------------------------------------------------------------------
# beam_search_ref
# ---------------------------------------------------------------------------
def _int_graph(seed, n=300, d=8, m2=8, b=6):
    rng = np.random.default_rng(seed)
    vec = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    nbrs = rng.integers(0, n, size=(n, m2)).astype(np.int32)
    nbrs[rng.random((n, m2)) < 0.15] = -1                   # -1 padding
    nbrs[rng.integers(0, n, size=5)] = -1                    # whole -1 rows
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    ep = rng.integers(0, n, size=b).astype(np.int32)
    return vec, nbrs, q, ep


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("expand_t", [1, 4])
@pytest.mark.parametrize("max_iters", [None, 0, 5])
def test_beam_search_ref_matches_jax(metric, expand_t, max_iters):
    vec, nbrs, q, ep = _int_graph(8)
    ep_d = np.asarray(jref.gather_distance_ref(
        jnp.asarray(vec), jnp.asarray(q), jnp.asarray(ep[:, None]),
        metric=metric))[:, 0]
    kw = dict(ef=16, metric=metric, expand_t=expand_t, max_iters=max_iters)
    ji, jd = jref.beam_search_ref(jnp.asarray(vec), jnp.asarray(nbrs),
                                  jnp.asarray(q), jnp.asarray(ep),
                                  jnp.asarray(ep_d), **kw)
    ti, td = tref.beam_search_ref(_t(vec), _t(nbrs), _t(q), _t(ep),
                                  _t(ep_d), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("expand_t", [1, 4])
def test_beam_search_ref_visited_counts_the_search_work(expand_t):
    # ef above N: nothing leaves a beam, so every scored row is returned,
    # no row is scored twice for one query, and every returned node is
    # expanded before the budget runs out
    vec, nbrs, q, ep = _int_graph(9)
    ep_d = tref.gather_distance_ref(_t(vec), _t(q), _t(ep[:, None]),
                                    metric="l2")[:, 0]
    kw = dict(ef=512, metric="l2", expand_t=expand_t)
    ids, dists = tref.beam_search_ref(_t(vec), _t(nbrs), _t(q), _t(ep), ep_d,
                                      **kw)
    vi, vd, seen = tref.beam_search_ref(_t(vec), _t(nbrs), _t(q), _t(ep),
                                        ep_d, return_visited=True, **kw)
    assert torch.equal(vi, ids) and torch.equal(vd, dists)
    returned = [set(row[row >= 0].tolist()) for row in ids]
    scored = set().union(*(r - {int(e)} for r, e in zip(returned, ep)))
    assert set(torch.nonzero(seen["rows"])[:, 0].tolist()) == scored
    assert set(torch.nonzero(seen["lists"])[:, 0].tolist()) \
        == set().union(*returned)
    assert seen["pairs"] == sum(len(r) - 1 for r in returned)


def test_beam_schedule_follows_reference_budget():
    assert tref.beam_schedule(64, 4, None) == (4, 68, 17)
    assert tref.beam_schedule(64, 1, None) == (1, 64, 64)
    assert tref.beam_schedule(10, 4, 0) == (4, 0, 0)
    assert tref.beam_schedule(2, 8, None) == (2, 4, 2)


# ---------------------------------------------------------------------------
# flash_decode_ref
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("per_seq", [False, True])
def test_flash_decode_ref_matches_jax(g, per_seq):
    rng = np.random.default_rng(10 + g)
    b, kvh, dh, s = 3, 2, 16, 40
    h = g * kvh
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    cur = np.array([1, 17, 40], np.int32) if per_seq else np.int32(23)
    want = np.asarray(jref.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur)))
    got = tref.flash_decode_ref(_t(q), _t(k), _t(v), _t(np.asarray(cur)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and through both packages' public ops entry points
    np.testing.assert_allclose(
        tops.flash_decode(_t(q), _t(k), _t(v), _t(np.asarray(cur))).numpy(),
        np.asarray(jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(cur))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("dh", [1030, 1152, 2048])
def test_flash_decode_ref_matches_jax_at_wide_heads(dh):
    """Heads wider than 1,024 floats (the card's wide-head kernel): the
    plain version against the reference's on the same inputs."""
    rng = np.random.default_rng(dh)
    b, kvh, g, s = 2, 2, 2, 30
    q = rng.normal(size=(b, g * kvh, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    cur = np.array([30, 7], np.int32)
    want = np.asarray(jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(cur)))
    got = tops.flash_decode(_t(q), _t(k), _t(v), _t(cur))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# embedding_bag: the kernel's member split and summation order, mirrored
# ---------------------------------------------------------------------------
def mirror_embedding_bag(table, ids, w, combine, splits, width):
    """embedding_bag.cu's order, one bag at a time, in fp32: a bag's L
    members cut into ``splits`` contiguous ranges (one warp each); a warp
    takes its range in rounds of 32 members, lane group g of G = 32 //
    width adding members j0 + i G + g of a round (j0 in steps of G x 8,
    i < 8) in that order; group 0 adds groups 1 .. G-1; the block adds
    the splits in order, then divides by L or max(sum w, 1e-9)."""
    b, l = ids.shape
    groups = 32 // width
    rows = table.float()
    out = torch.empty(b, table.shape[1])
    seen = torch.zeros(b, l, dtype=torch.int64)
    for bag in range(b):
        tot = torch.zeros(table.shape[1])
        wtot = torch.zeros(())
        for s in range(splits):
            lo, hi = s * l // splits, (s + 1) * l // splits
            acc = [torch.zeros(table.shape[1]) for _ in range(groups)]
            wsum = torch.zeros(())
            for r0 in range(lo, hi, 32):
                n = min(32, hi - r0)
                for j0 in range(0, n, groups * 8):
                    for i in range(8):
                        for g in range(groups):
                            j = j0 + i * groups + g
                            if j < n:
                                m = r0 + j
                                wt = w[bag, m] if w is not None else 1.0
                                acc[g] = acc[g] + wt * rows[ids[bag, m]]
                                seen[bag, m] += 1
                wsum = wsum + (w[bag, r0:r0 + n].sum() if w is not None
                               else 0.0)
            for g in range(1, groups):
                acc[0] = acc[0] + acc[g]
            tot = tot + acc[0]
            wtot = wtot + wsum
        if combine == "mean":
            tot = tot / (float(l) if w is None
                         else torch.clamp_min(wtot, 1e-9))
        out[bag] = tot
    assert bool((seen == 1).all())          # every member once
    return out


@pytest.mark.parametrize("b,l,e", [(512, 50, 64), (262_144, 50, 64),
                                   (1, 50, 64), (1, 1, 64), (77, 1, 10),
                                   (512, 4, 64), (8, 50, 2000)])
def test_bag_plan(b, l, e):
    """A whole bag a warp when B warps fill 132 SMs (32 an SM); a smaller
    batch splits a bag over up to 8 warps, each with two members at
    least, while the block's partials fit 48 KB."""
    splits = tops._bag_plan(b, l, e, 132)
    assert splits in (1, 2, 4, 8)
    want = {(512, 50, 64): 8, (262_144, 50, 64): 1, (1, 50, 64): 8,
            (1, 1, 64): 1, (77, 1, 10): 1, (512, 4, 64): 2,
            (8, 50, 2000): 1}[(b, l, e)]
    assert splits == want
    assert splits == 1 or 2 * splits <= l


@pytest.mark.parametrize("splits,width", [(1, 16), (8, 16), (4, 8),
                                          (2, 10), (1, 32), (8, 32)])
@pytest.mark.parametrize("weights", [None, "mask"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_mirror_matches_jax(splits, width, weights, combine):
    """The kernel's member split and summation order (a warp's rounds of
    32, its lane groups, the splits) adds every member once and equals
    the reference within 1e-5; on integer rows with 0/1 weights
    exactly."""
    rng = np.random.default_rng(splits * 100 + width)
    b, l, e = 5, 75, 12
    for table in (rng.normal(size=(300, e)).astype(np.float32),
                  rng.integers(-8, 9, size=(300, e)).astype(np.float32)):
        ids = rng.integers(0, 300, size=(b, l)).astype(np.int32)
        w = None
        if weights == "mask":
            w = (np.arange(l)[None] < rng.integers(1, l + 1, size=(b, 1))
                 ).astype(np.float32)
        want = np.asarray(jref.embedding_bag_ref(
            jnp.asarray(table), jnp.asarray(ids),
            None if w is None else jnp.asarray(w), combine=combine))
        got = mirror_embedding_bag(_t(table), _t(ids).long(),
                                   None if w is None else _t(w), combine,
                                   splits, width)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        if combine == "sum" and float(table[0, 0]).is_integer():
            np.testing.assert_array_equal(got.numpy(), want)
