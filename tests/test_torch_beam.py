"""The arithmetic of the ``beam_search`` CUDA kernel, mirrored in torch on
the CPU (a CUDA kernel has no CPU mode), against the JAX package's
``repro.kernels.ref`` on the same numpy inputs.

The mirror follows ``kernels/csrc/beam_search.cu`` step for step:

- dedup: one open-addressing id table a hop (2^k >= 2 (ef + T 2M)
  slots, Fibonacci hash, linear probing) that already holds the beam's
  ids; each valid candidate slot, in a shuffled order (the kernel's
  atomics have none), claims its id and is kept iff the id was not
  there: the reference's kept ids, once each;
- the rank merge: (d, id) as one 64-bit key (d's bits made monotone, -0
  as +0; the id's sign bit flipped), survivors compacted in a shuffled
  order (an atomic counter's), a candidate past the beam's ef-th key
  dropped, then each beam entry at slot p + (candidates below it) and
  each candidate at (beam keys below it, a binary search) + (candidates
  below it), plus the empty slots outside beam[0, ef) for a key past the
  empty slots' (INF, -1); written if below ef, every other slot empty;
- the whole search: the entry point at slot ef - 1 when its key sorts
  after the empty slots', the frontier, the dedup, distances, the merge.

They are held against ``beam_dedup_valid``, ``beam_merge`` and
``beam_search_ref`` of ``repro.kernels.ref`` on JAX-CPU: ids, distances
and expanded bits exactly (the distances are the same numbers, moved).
``ops._beam_plan`` is held here too: its shared bytes stay within the
card's 227 KB a block, and it raises on a shape that no plan fits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

INF = tref.BEAM_INF


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the kernel's dedup
# ---------------------------------------------------------------------------
def hash_bits(ef, w):
    s = tref.next_pow2(2 * (ef + w))
    return s.bit_length() - 1


def mirror_dedup(cand, valid, bi, ef, rng, wave=None):
    """keep [B, w]: the kernel's dedup, one row at a time. The hop's table
    holds the beam's ids (``bi`` [B, efp], its live slots below ef); each
    valid slot, in a shuffled order (the kernel's atomics have none),
    claims its id: it is kept iff the id was not there yet. ``wave``: the
    slots claim in waves of that many (2 x the block's threads), each
    wave's order shuffled, as the kernel takes a hop of more candidates."""
    b, w = cand.shape
    bits = hash_bits(ef, w)
    mask = (1 << bits) - 1
    keep = torch.zeros((b, w), dtype=torch.bool)
    for r in range(b):
        tab = [-1] * (1 << bits)

        def claim(i):
            s = ((int(i) * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
            while tab[s] != -1:
                if tab[s] == int(i):
                    return False
                s = (s + 1) & mask
            tab[s] = int(i)
            return True

        for p in range(ef):
            if bi[r, p] >= 0:
                assert claim(bi[r, p])          # the beam's ids are distinct
        order = rng.permutation(w) if wave is None else np.concatenate(
            [c0 + rng.permutation(min(wave, w - c0))
             for c0 in range(0, w, wave)])
        for c in order:
            keep[r, c] = bool(valid[r, c]) and claim(cand[r, c])
    return keep


def kept_ids(cand, keep):
    """Per row, the sorted ids of the kept slots (each id at most once)."""
    out = []
    for r in range(cand.shape[0]):
        ids = sorted(int(i) for i in np.asarray(cand[r])[np.asarray(keep[r])])
        assert len(ids) == len(set(ids))
        out.append(ids)
    return out


# ---------------------------------------------------------------------------
# the kernel's rank merge
# ---------------------------------------------------------------------------
def key64(d, i):
    """(d, id) -> int64 keys ordered as the kernel's unsigned 64-bit keys
    (the high word offset by 2^31 so that a signed compare keeps the
    order)."""
    d = torch.as_tensor(d, dtype=torch.float32) + 0.0      # -0 -> +0
    u = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    lo = (torch.as_tensor(i, dtype=torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    return ((u - 0x80000000) << 32) + lo


PAD = int(key64(INF, -1))


def mirror_merge(bd, bi, bx, sel, cd, ci, keep, ef, rng):
    """The next beam (d, id, expanded) [B, efp] from this hop's beam
    (``bx`` before the frontier, ``sel`` the frontier's slots), the w
    candidate slots (cd, ci) and the dedup's ``keep``."""
    b, efp = bd.shape
    w = cd.shape[1]
    nd = torch.full((b, efp), INF, dtype=torch.float32)
    ni = torch.full((b, efp), -1, dtype=torch.int32)
    nx = torch.ones((b, efp), dtype=torch.bool)
    for r in range(b):
        kept = torch.nonzero(keep[r])[:, 0]
        kept = kept[torch.from_numpy(rng.permutation(len(kept)))]
        nk = len(kept)
        worst = int(key64(bd[r, ef - 1], bi[r, ef - 1]))
        ck = key64(cd[r, kept], ci[r, kept])
        live = ck < worst                       # can still enter the beam
        sk, sd, si = ck[live], cd[r, kept][live], ci[r, kept][live]
        extra = (efp - ef) + (w - nk)
        bk = key64(bd[r, :ef], bi[r, :ef])
        for p in range(ef):
            if bi[r, p] < 0:
                continue
            k = int(bk[p])
            rank = p + int((sk < k).sum()) + (extra if k > PAD else 0)
            if rank < ef:
                nd[r, rank], ni[r, rank] = bd[r, p], bi[r, p]
                nx[r, rank] = bool(bx[r, p]) or bool(sel[r, p])
        for j in range(len(sk)):
            k = int(sk[j])
            below = int(torch.searchsorted(bk, torch.tensor([k]))[0])
            rank = below + int((sk < k).sum()) + (extra if k > PAD else 0)
            if rank < ef:
                nd[r, rank], ni[r, rank], nx[r, rank] = sd[j], si[j], False
    return nd, ni, nx


# ---------------------------------------------------------------------------
# one hop's dedup and merge against the JAX reference
# ---------------------------------------------------------------------------
def _hop_inputs(seed, b, ef, t, m2, *, pool, pad=0.2, all_invalid=False,
                inf_tail=False):
    """A sorted beam (ids drawn from ``pool``, ties in d, some entries
    expanded), t neighbour lists of m2 slots with -1 padding and ids repeated within
    and across the lists and from the beam, and candidate distances."""
    rng = np.random.default_rng(seed)
    efp = tref.next_pow2(ef)
    live = rng.integers(1, min(ef, pool // 2) + 1, size=b)
    bd = np.full((b, efp), INF, np.float32)
    bi = np.full((b, efp), -1, np.int32)
    bx = np.ones((b, efp), bool)
    for r in range(b):
        ids = rng.choice(pool, size=live[r], replace=False).astype(np.int32)
        d = rng.integers(0, 50, size=live[r]).astype(np.float32)   # ties
        order = np.lexsort((ids, d))
        bd[r, :live[r]], bi[r, :live[r]] = d[order], ids[order]
        bx[r, :live[r]] = rng.random(live[r]) < 0.5
    w = t * m2
    cand = rng.integers(0, pool, size=(b, w)).astype(np.int32)
    dup = rng.random((b, w)) < 0.25                 # repeat an earlier id
    for r in range(b):
        for c in range(1, w):
            if dup[r, c]:
                cand[r, c] = cand[r, rng.integers(0, c)]
        take = rng.random(w) < 0.2                  # ids already in the beam
        nlive = int((bi[r] >= 0).sum())
        cand[r, take] = bi[r, rng.integers(0, nlive, size=int(take.sum()))]
    valid = (rng.random((b, w)) >= pad) & (not all_invalid)
    # a candidate's distance is its id's (ties across ids)
    dist_of = rng.integers(0, 60, size=(b, pool)).astype(np.float32)
    if inf_tail:
        dist_of[:, rng.integers(0, pool, size=pool // 10)] = np.float32(np.inf)
    cd = np.take_along_axis(dist_of, cand.astype(np.int64), axis=1)
    return bd, bi, bx, cand, valid, cd


@pytest.mark.parametrize("ef,t,m2", [
    (10, 4, 10), (20, 4, 10), (24, 3, 8), (40, 4, 16), (64, 4, 32),
    (16, 1, 32), (7, 2, 5)])
@pytest.mark.parametrize("pool", [40, 5000])
def test_dedup_matches_jax(ef, t, m2, pool):
    bd, bi, bx, cand, valid, _ = _hop_inputs(ef * 7 + m2, 6, ef, t, m2,
                                             pool=pool)
    want = jref.beam_dedup_valid(jnp.asarray(cand), jnp.asarray(valid),
                                 jnp.asarray(bi))
    got = mirror_dedup(_t(cand), _t(valid), _t(bi), ef,
                       np.random.default_rng(ef))
    # the same ids kept, once each (which copy is kept does not matter:
    # a copy's row and distance are its id's)
    assert kept_ids(cand, got.numpy()) == kept_ids(cand, np.asarray(want))


@pytest.mark.parametrize("ef,t,m2,wave", [
    (64, 4, 258, 1024), (64, 4, 512, 1024), (64, 1, 2049, 1024),
    (20, 4, 300, 256)])
@pytest.mark.parametrize("pool", [40, 5000])
def test_dedup_in_waves_matches_jax(ef, t, m2, wave, pool):
    """A hop of more than 1,024 candidates (M > 128 at T 4) claims its
    slots wave by wave: the same ids kept, once each."""
    bd, bi, bx, cand, valid, _ = _hop_inputs(ef + m2 + wave, 3, ef, t, m2,
                                             pool=pool)
    want = jref.beam_dedup_valid(jnp.asarray(cand), jnp.asarray(valid),
                                 jnp.asarray(bi))
    got = mirror_dedup(_t(cand), _t(valid), _t(bi), ef,
                       np.random.default_rng(m2), wave=wave)
    assert kept_ids(cand, got.numpy()) == kept_ids(cand, np.asarray(want))


def _merge_case(seed, ef, t, m2, pool, **kw):
    bd, bi, bx, cand, valid, cd = _hop_inputs(seed, 5, ef, t, m2,
                                              pool=pool, **kw)
    keep = np.asarray(jref.beam_dedup_valid(
        jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(bi)))
    got_keep = mirror_dedup(_t(cand), _t(valid), _t(bi), ef,
                            np.random.default_rng(seed))
    assert kept_ids(cand, got_keep.numpy()) == kept_ids(cand, keep)
    # the frontier of this hop: its expanded bits go through the merge
    t_live = min(t, ef)
    nbx, _ = jref.beam_select_frontier(jnp.asarray(bd), jnp.asarray(bi),
                                       jnp.asarray(bx), t_live, t)
    nbx = np.asarray(nbx)
    sel = nbx & ~bx
    ccd = np.where(keep, cd, INF).astype(np.float32)
    cci = np.where(keep, cand, -1).astype(np.int32)
    want = jax.jit(jref.beam_merge, static_argnums=(5, 6))(
        jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(nbx), jnp.asarray(ccd),
        jnp.asarray(cci), ef, False)
    got = mirror_merge(_t(bd), _t(bi), _t(bx), _t(sel), _t(cd), _t(cand),
                       got_keep, ef, np.random.default_rng(seed + 1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    live = np.asarray(want[1]) >= 0          # pads' expanded bit is unread
    np.testing.assert_array_equal(got[2].numpy()[live],
                                  np.asarray(want[2])[live])


@pytest.mark.parametrize("ef,t,m2", [
    (10, 4, 10), (20, 4, 10), (24, 3, 8), (40, 4, 16), (64, 4, 32),
    (64, 4, 64), (16, 1, 32), (1, 1, 4)])
@pytest.mark.parametrize("pool", [40, 5000])
def test_rank_merge_matches_jax(ef, t, m2, pool):
    _merge_case(ef * 3 + m2 + pool, ef, t, m2, pool)


@pytest.mark.parametrize("ef", [10, 20, 24, 40])
def test_rank_merge_every_candidate_invalid(ef):
    _merge_case(ef, ef, 4, 10, 500, all_invalid=True)


@pytest.mark.parametrize("ef", [10, 24])
def test_rank_merge_candidates_past_the_empty_slots(ef):
    """Infinite candidate distances sort after the (INF, -1) empty slots:
    the rank adds the empty slots outside beam[0, ef)."""
    _merge_case(ef + 100, ef, 4, 10, 500, inf_tail=True)


def test_key_order_is_the_two_key_order():
    rng = np.random.default_rng(3)
    d = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 1.0, INF, np.inf],
                            np.float32), size=400)
    i = rng.integers(-1, 6, size=400).astype(np.int32)
    k = key64(_t(d), _t(i)).numpy()
    o = np.lexsort((i, d))                     # -0 == +0 as a float compare
    assert np.all(np.diff(k[o]) >= 0)
    same = (d[o][1:] == d[o][:-1]) & (i[o][1:] == i[o][:-1])
    assert np.array_equal(np.diff(k[o]) == 0, same)


# ---------------------------------------------------------------------------
# the whole search, hop by hop as the kernel runs it
# ---------------------------------------------------------------------------
def mirror_beam_search(vec, nbrs, q, ep, ep_d, *, ef, metric, expand_t,
                       max_iters, seed=0, wave=None):
    rng = np.random.default_rng(seed)
    n, m2 = nbrs.shape
    b = q.shape[0]
    t, budget, hops = tref.beam_schedule(ef, expand_t, max_iters)
    efp = tref.next_pow2(ef)
    bd = torch.full((b, efp), INF, dtype=torch.float32)
    bi = torch.full((b, efp), -1, dtype=torch.int32)
    bx = torch.ones((b, efp), dtype=torch.bool)
    for r in range(b):
        late = (hops > 0 and ep[r] >= 0
                and int(key64(ep_d[r], ep[r])) > PAD)
        p = ef - 1 if late else 0
        bd[r, p], bi[r, p], bx[r, p] = ep_d[r], ep[r], False
    for hop in range(hops):
        # a query with no unexpanded entry has converged: its block leaves
        # the hop loop (the others go on)
        active = ((~bx) & (bi >= 0)).any(dim=-1)
        if not bool(active.any()):
            break
        t_live = min(t, budget - hop * t)
        nbx, nodes = tref.beam_select_frontier(bd, bi, bx, t_live, t)
        sel = nbx & ~bx
        lists = nbrs[nodes.clamp(0, n - 1).long()]
        valid = ((nodes >= 0)[:, :, None] & (lists >= 0)).reshape(b, -1)
        cand = lists.clamp(0, n - 1).reshape(b, -1)
        keep = mirror_dedup(cand, valid, bi, ef, rng, wave)
        cd = tref.gather_distance_ref(vec, q, cand, metric=metric)
        nd, ni, nx = mirror_merge(bd, bi, bx, sel, cd, cand, keep, ef, rng)
        a = active[:, None]
        bd, bi, bx = (torch.where(a, nd, bd), torch.where(a, ni, bi),
                      torch.where(a, nx, bx))
    return bi[:, :ef], bd[:, :ef]


def _int_graph(seed, n=300, d=8, m2=8, b=6, repeat=False):
    rng = np.random.default_rng(seed)
    vec = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    nbrs = rng.integers(0, n, size=(n, m2)).astype(np.int32)
    if repeat:                                  # lists of a few ids, repeated
        nbrs = rng.integers(0, 12, size=(n, m2)).astype(np.int32)
    nbrs[rng.random((n, m2)) < 0.15] = -1
    nbrs[rng.integers(0, n, size=5)] = -1
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    ep = rng.integers(0, n, size=b).astype(np.int32)
    return vec, nbrs, q, ep


@pytest.mark.parametrize("expand_t,ef,m2,max_iters,repeat", [
    (4, 16, 8, None, False), (1, 16, 8, None, False),
    (4, 10, 10, None, False), (3, 20, 8, None, True),
    (4, 24, 8, 5, False), (4, 16, 8, 0, False), (1, 40, 8, None, True)])
def test_whole_search_matches_jax(expand_t, ef, m2, max_iters, repeat):
    vec, nbrs, q, ep = _int_graph(ef + m2, m2=m2, repeat=repeat)
    ep_d = np.asarray(jref.gather_distance_ref(
        jnp.asarray(vec), jnp.asarray(q), jnp.asarray(ep[:, None]),
        metric="l2"))[:, 0]
    kw = dict(ef=ef, metric="l2", expand_t=expand_t, max_iters=max_iters)
    ji, jd = jref.beam_search_ref(jnp.asarray(vec), jnp.asarray(nbrs),
                                  jnp.asarray(q), jnp.asarray(ep),
                                  jnp.asarray(ep_d), **kw)
    ti, td = mirror_beam_search(_t(vec), _t(nbrs), _t(q), _t(ep), _t(ep_d),
                                **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("expand_t,m2", [(4, 260), (1, 1030)])
def test_whole_search_in_waves_matches_jax(expand_t, m2):
    """M > 128 at T 4 (and 2M > 1,024 at T 1): every hop's dedup in waves
    of 1,024 candidates, the search equals the reference's."""
    vec, nbrs, q, ep = _int_graph(m2, n=1500, d=8, m2=m2, b=3)
    ep_d = np.asarray(jref.gather_distance_ref(
        jnp.asarray(vec), jnp.asarray(q), jnp.asarray(ep[:, None]),
        metric="l2"))[:, 0]
    kw = dict(ef=16, metric="l2", expand_t=expand_t, max_iters=3)
    ji, jd = jref.beam_search_ref(jnp.asarray(vec), jnp.asarray(nbrs),
                                  jnp.asarray(q), jnp.asarray(ep),
                                  jnp.asarray(ep_d), **kw)
    ti, td = mirror_beam_search(_t(vec), _t(nbrs), _t(q), _t(ep), _t(ep_d),
                                wave=1024, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_whole_search_entry_past_the_empty_slots():
    """An entry distance past INF starts at slot ef - 1, a sorted beam;
    with no hop to run it stays at slot 0, as the reference returns it."""
    vec, nbrs, q, ep = _int_graph(31, m2=8)
    ep_d = np.full(len(ep), np.inf, np.float32)
    for max_iters in (None, 0):
        kw = dict(ef=12, metric="l2", expand_t=4, max_iters=max_iters)
        ji, jd = jref.beam_search_ref(jnp.asarray(vec), jnp.asarray(nbrs),
                                      jnp.asarray(q), jnp.asarray(ep),
                                      jnp.asarray(ep_d), **kw)
        ti, td = mirror_beam_search(_t(vec), _t(nbrs), _t(q), _t(ep),
                                    _t(ep_d), **kw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("expand_t,ef", [(4, 8), (1, 8), (4, 16), (2, 12)])
def test_whole_search_distances_past_inf(expand_t, ef):
    """Rows whose l2 distance overflows to inf sort after the (INF, -1)
    empty slots: the merge ranks them after every empty slot outside
    beam[0, ef), and an infinite entry point starts at slot ef - 1."""
    vec, nbrs, q, ep = _int_graph(ef * 5 + expand_t, m2=4)
    huge = np.random.default_rng(ef).random(len(vec)) < 0.6
    huge[ep[:3]], huge[ep[3:]] = True, False     # half the entry points
    vec[huge] *= np.float32(1e19)
    ep_d = np.asarray(jref.gather_distance_ref(
        jnp.asarray(vec), jnp.asarray(q), jnp.asarray(ep[:, None]),
        metric="l2"))[:, 0]
    assert np.isinf(ep_d).any() and np.isinf(ep_d).mean() < 1
    kw = dict(ef=ef, metric="l2", expand_t=expand_t, max_iters=None)
    ji, jd = jref.beam_search_ref(jnp.asarray(vec), jnp.asarray(nbrs),
                                  jnp.asarray(q), jnp.asarray(ep),
                                  jnp.asarray(ep_d), **kw)
    ti, td = mirror_beam_search(_t(vec), _t(nbrs), _t(q), _t(ep), _t(ep_d),
                                **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# the block plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d", [16, 30, 384, 1000, 1536])
@pytest.mark.parametrize("t", [1, 4])
def test_beam_plan_fits_the_card(codec, d, t):
    elem = tops._ELEM_BYTES[codec]
    for m2 in (10, 32, 64):
        for b in (1, 8, 1024):
            for ef in (20, 64):
                threads, ring, smem = tops._beam_plan(b, d, codec, m2, ef, t,
                                                      132)
                assert smem <= 232_448
                assert smem == tops._beam_layout_bytes(d, elem, m2, ef, t,
                                                       threads, ring)
                assert threads % 32 == 0 and 128 <= threads <= 512
                assert t * m2 <= 2 * threads
                assert 1 <= ring <= t * m2
                if b <= 132 and smem - ring * -(-d * elem // 16) * 16 \
                        + t * m2 * -(-d * elem // 16) * 16 <= 232_448:
                    assert ring == t * m2        # the whole hop in flight
                if b == 1024:     # every block that the registers allow
                    per_sm = min(8, 1024 // threads)
                    assert per_sm * (smem + 1024) <= 233_472


def test_beam_plan_served_and_build_shapes():
    # the served tick: fp32 rows of 384 at T 4, 2M 32: a whole hop in
    # flight; the bulk build (B 1024, 2M 10, ef 20) keeps 8 blocks an SM
    assert tops._beam_plan(8, 384, "fp32", 32, 64, 4, 132)[:2] == (512, 128)
    assert tops._beam_plan(8, 384, "int8", 32, 64, 4, 132)[:2] == (512, 128)
    threads, ring, smem = tops._beam_plan(1024, 384, "int8", 10, 20, 4, 132)
    assert threads == 128 and ring == 40
    # 133..264 queries: 2 an SM; 265..528: 4
    assert tops._beam_plan(200, 384, "int8", 32, 64, 4, 132)[0] == 512
    assert tops._beam_plan(400, 384, "int8", 32, 64, 4, 132)[0] == 256


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [129, 200, 256])
@pytest.mark.parametrize("t", [4, 1])
@pytest.mark.parametrize("b", [8, 1024])
def test_beam_plan_serves_past_1024_candidates(codec, m, t, b):
    """M 129 to 256 at D 384, ef 64: T 2M up to 2,048 candidates a hop go
    through waves of two a thread, and the search state (id tables of
    2^k >= 2 (ef + T 2M) slots, 24 bytes a candidate) leaves rows for
    the ring."""
    elem = tops._ELEM_BYTES[codec]
    m2 = 2 * m
    threads, ring, smem = tops._beam_plan(b, 384, codec, m2, 64, t, 132)
    assert threads % 32 == 0 and 128 <= threads <= 512
    assert 1 <= ring <= t * m2
    assert smem == tops._beam_layout_bytes(384, elem, m2, 64, t, threads,
                                           ring)
    assert smem <= 232_448
    if t == 1 and codec == "int8" and b == 8:
        assert ring == t * m2                    # the whole hop in flight


@pytest.mark.parametrize("d,codec,m2,t", [
    (384, "int8", 600, 4),          # 2,400 candidates a hop
    (384, "fp32", 2049, 1)])
def test_beam_plan_serves_wide_hops(d, codec, m2, t):
    threads, ring, smem = tops._beam_plan(8, d, codec, m2, 64, t, 132)
    assert threads == 512 and ring >= 1 and smem <= 232_448


def test_beam_plan_limit_is_the_search_state():
    # ef 64 at D 384: the id tables reach 2^14 slots (128 KB) past
    # ef + T 2M = 4,096, where no fp32 row fits beside the state
    for t, last in ((4, 1008), (1, 4032)):
        tops._beam_plan(8, 384, "fp32", last, 64, t, 132)
        with pytest.raises(ValueError, match="no block shape"):
            tops._beam_plan(8, 384, "fp32", last + 1, 64, t, 132)


@pytest.mark.parametrize("d,codec,m2,t", [
    (60_000, "fp32", 32, 4),        # one row past 227 KB
    (384, "fp32", 1009, 4),         # just past the limit at T 4
    (384, "fp32", 4033, 1)])        # and at T 1
def test_beam_plan_raises_on_what_no_plan_fits(d, codec, m2, t):
    with pytest.raises(ValueError, match="no block shape"):
        tops._beam_plan(8, d, codec, m2, 64, t, 132)
