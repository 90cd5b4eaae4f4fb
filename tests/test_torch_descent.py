"""The upper-layer greedy descent of the port (CPU): its plain version
``ref.greedy_descent_ref`` against the JAX package's ``_greedy_layer``
applied layer by layer, the descent kernel's per-query termination
mirrored in torch against the lock-step loop, and the block plans of the
descent and of the hop kernel (``ops._descent_plan``,
``ops._gather_plan``).

The kernel (``kernels/csrc/gather_distance.cu``) has no CPU mode; its
card tests are in ``tests/test_torch_cuda.py``. The mirror follows it:
each query runs alone and stops as soon as a hop does not improve it,
slots with id < 0 score INF, the argmin keeps the lowest slot among
equal distances, a query moves only when the best beats its distance.

Tolerances: ep exactly equal; ep_dist within 1e-5 (the two frameworks
sum a distance in another order), exactly equal on integer-valued l2
rows, whose arithmetic is exact. The mirror and the lock-step loop read
one table of distances, so they must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as jhnsw
from repro.core import hnsw_build as jbuild
from repro.core import codec as jcodec
from repro.kernels import ref as jref
from repro_torch.core import codec as tcodec
from repro_torch.core import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

INF = tref.BEAM_INF


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _case(seed, n, d, m, layers, b, integer):
    """Rows, queries and an upper table [L, N, M] with 15 % -1 padding, a
    few all -1 lists, and the entry's list all -1 in the second layer from
    the top (a hop whose every slot scores INF)."""
    rng = np.random.default_rng(seed)
    if integer:
        vec = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    else:
        vec, q = (_unit(rng.normal(size=(n, d))),
                  _unit(rng.normal(size=(b, d))))
    up = rng.integers(0, n, size=(layers, n, m)).astype(np.int32)
    up[rng.random(up.shape) < 0.15] = -1
    up[:, rng.integers(0, n, size=5)] = -1
    ep = np.full(b, 3, np.int32)
    ep[b // 2:] = rng.integers(0, n, size=b - b // 2)
    if layers >= 2:
        up[layers - 2, 3] = -1
    return vec, q, up, ep


def _rows(codec, vec, integer):
    """The rows of ``codec`` in both packages: (jax rows, scales), (torch
    rows, scales), each encoded by its own codec; integer-valued int8
    rows go in raw with scales 1.0."""
    if codec == "fp32":
        return (jnp.asarray(vec), None), (_t(vec), None)
    if codec == "int8" and integer:
        return ((jnp.asarray(vec.astype(np.int8)), jnp.ones(len(vec))),
                (_t(vec.astype(np.int8)), torch.ones(len(vec))))
    jenc, jscl = jcodec.get_codec(codec).encode(vec)
    tenc, tscl = tcodec.get_codec(codec).encode(vec)
    return ((jnp.asarray(jenc), None if jscl is None else jnp.asarray(jscl)),
            (tcodec.device_rows(tenc, "cpu"),
             None if tscl is None else _t(tscl)))


def _jax_descent(vec, up, jrows, jscales, q, ep, ep_d, metric, max_level):
    """The reference's ``_greedy_layer`` applied layer by layer, on a
    device graph made by ``to_device_graph`` from the rows and the table."""
    n = vec.shape[0]
    g = jbuild.HNSWGraph(
        vectors=vec, neighbors0=np.full((n, 2), -1, np.int32), upper=up,
        levels=np.zeros(n, np.int32), entry=0, max_level=max_level,
        metric=metric, n=n)
    enc = None if jrows.dtype == jnp.float32 else np.asarray(jrows)
    scl = None if jscales is None else np.asarray(jscales)
    dg = jhnsw.to_device_graph(g, enc=enc, scales=scl)
    e, d = jnp.asarray(ep), jnp.asarray(ep_d)
    for layer in range(max_level, 0, -1):
        e, d = jhnsw._greedy_layer(dg, jnp.asarray(q), e, d, layer)
    return np.asarray(e), np.asarray(d)


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("max_level", [0, 1, 4])
def test_greedy_descent_ref_matches_jax(codec, metric, max_level):
    vec, q, up, ep = _case(50, 400, 24, 6, 4, 9, integer=False)
    (jv, js), (tv, ts) = _rows(codec, vec, False)
    ep_d = np.asarray(jref.gather_distance_ref(
        jv, jnp.asarray(q), jnp.asarray(ep[:, None]), metric=metric,
        scales=js))[:, 0]
    we, wd = _jax_descent(vec, up, jv, js, q, ep, ep_d, metric, max_level)
    ge, gd = tref.greedy_descent_ref(tv, _t(up), _t(q), _t(ep), _t(ep_d),
                                     max_level=max_level, metric=metric,
                                     scales=ts)
    np.testing.assert_array_equal(ge.numpy(), we)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=0, atol=1e-5)
    if max_level:
        assert (ge.numpy() != ep).any()


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("max_level", [3, 5])
def test_greedy_descent_ref_exact_on_integer_rows(codec, metric, max_level):
    """Integer-valued rows: many equal distances, so the lowest-slot rule
    decides; ep and ep_dist exactly equal the reference's."""
    vec, q, up, ep = _case(51, 300, 16, 8, 5, 12, integer=True)
    (jv, js), (tv, ts) = _rows(codec, vec, True)
    ep_d = np.asarray(jref.gather_distance_ref(
        jv, jnp.asarray(q), jnp.asarray(ep[:, None]), metric=metric,
        scales=js))[:, 0]
    we, wd = _jax_descent(vec, up, jv, js, q, ep, ep_d, metric, max_level)
    ge, gd = tref.greedy_descent_ref(tv, _t(up), _t(q), _t(ep), _t(ep_d),
                                     max_level=max_level, metric=metric,
                                     scales=ts)
    np.testing.assert_array_equal(ge.numpy(), we)
    np.testing.assert_array_equal(gd.numpy(), wd)


def test_ops_descent_on_the_cpu_is_the_plain_version():
    """``ops.greedy_descent`` on CPU tensors runs the plain version: no
    kernel counted, one host sync a lock-step hop plus one a layer."""
    vec, q, up, ep = _case(52, 300, 16, 8, 3, 6, integer=False)
    ep_d = tref.gather_distance_ref(_t(vec), _t(q), _t(ep[:, None]))[:, 0]
    stats = {}
    want = tref.greedy_descent_ref(_t(vec), _t(up), _t(q), _t(ep), ep_d,
                                   max_level=3, stats=stats)
    dispatch.reset()
    got = tops.greedy_descent(_t(vec), _t(up), _t(q), _t(ep), ep_d,
                              max_level=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dispatch.get("hnsw.host_syncs") == stats["syncs"] \
        == stats["lockstep_hops"] + 3
    assert dispatch.get("hnsw.descent_launches") == 0
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)


# ---------------------------------------------------------------------------
# the kernel's per-query termination against the lock-step loop
# ---------------------------------------------------------------------------
def _before(d1, r1, d2, r2):
    """The kernel's argmin order: smaller distance (NaN first), then the
    lower slot."""
    n1, n2 = np.isnan(d1), np.isnan(d2)
    if n1 != n2:
        return n1
    if not n1 and d1 != d2:
        return d1 < d2
    return r1 < r2


def _warp_slots(m):
    """The list slots each warp of a descent block scores, in its order:
    warp w takes slots 4 w + j, then again every 4 x (its warps), the
    block having min(32, ceil(M / 4)) warps."""
    nw = min(32, -(-m // 4))
    return [[r0 + j for r0 in range(4 * w, m, 4 * nw)
             for j in range(4) if r0 + j < m] for w in range(nw)]


def mirror_descent(table_d, up, ep, ep_d, max_level):
    """greedy_descent_kernel's control flow, one query at a time: each hop
    scores its list from ``table_d`` [B, N] (slot id < 0 at INF, ids
    clamped), takes each warp's best (d, slot) over its slots, then the
    block's over the warps, in the kernel's order, and the query stops
    the layer at the first hop that does not improve it. Returns (ep,
    ep_dist, hops a query)."""
    n = table_d.shape[1]
    warps = _warp_slots(up.shape[2])
    out_e, out_d, hops = ep.copy(), ep_d.copy(), np.zeros(len(ep), int)
    for b in range(len(ep)):
        e, d = int(ep[b]), np.float32(ep_d[b])
        for layer in range(max_level, 0, -1):
            while True:
                hops[b] += 1
                nbrs = up[layer - 1, min(max(e, 0), n - 1)]
                best = (None, -1, 0)
                for slots in warps:
                    wb = (None, -1, 0)
                    for r in slots:
                        nb = nbrs[r]
                        i = min(max(int(nb), 0), n - 1)
                        dr = table_d[b, i] if nb >= 0 else np.float32(INF)
                        if wb[0] is None or _before(dr, r, wb[0], wb[1]):
                            wb = (dr, r, i)
                    if best[0] is None or _before(wb[0], wb[1], best[0],
                                                  best[1]):
                        best = wb
                if not best[0] < d:
                    break
                d, e = best[0], best[2]
        out_e[b], out_d[b] = e, d
    return out_e, out_d, hops


def _table_gather(table_d):
    """A ``gather`` for greedy_descent_ref that reads distances from the
    [B, N] table: the lock-step loop and the mirror see the same numbers."""
    def gather(vectors, q, ids, **_):
        return torch.gather(table_d, 1, ids.long())
    return gather


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("m,layers,max_level", [(6, 4, 4), (16, 3, 2),
                                                (5, 8, 8), (1, 3, 3),
                                                (130, 2, 2), (200, 2, 1),
                                                (256, 2, 2)])
def test_per_query_termination_is_the_lockstep_result(integer, m, layers,
                                                      max_level):
    vec, q, up, ep = _case(53 + m, 500, 16, m, layers, 24, integer)
    tv, tq = _t(vec), _t(q)
    metric = "l2" if integer else "cosine"
    table_d = tref.distance_topk_ref(tv, tq, 500, metric=metric)
    # back to row order: table_d[b, id]
    dist = torch.empty(24, 500)
    dist.scatter_(1, table_d[1].long(), table_d[0])
    ep_d = dist[torch.arange(24), _t(ep).long()]
    stats = {}
    we, wd = tref.greedy_descent_ref(tv, _t(up), tq, _t(ep), ep_d,
                                     max_level=max_level, metric=metric,
                                     gather=_table_gather(dist), stats=stats)
    ge, gd, hops = mirror_descent(dist.numpy(), up, ep, ep_d.numpy(),
                                  max_level)
    np.testing.assert_array_equal(ge, we.numpy())
    np.testing.assert_array_equal(gd, wd.numpy())
    # the hops each query needs are the plain version's count of them,
    # and fewer in all than the lock-step loop's B x hops
    np.testing.assert_array_equal(hops, stats["hops"].numpy())
    assert hops.sum() <= 24 * stats["lockstep_hops"]
    assert (ge != ep).any()


@pytest.mark.parametrize("m", [1, 5, 16, 128, 129, 200, 256, 1030])
def test_warp_slots_cover_the_list_once(m):
    slots = _warp_slots(m)
    assert len(slots) == min(32, -(-m // 4))
    assert sorted(r for w in slots for r in w) == list(range(m))


# ---------------------------------------------------------------------------
# the block plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d", [16, 30, 384, 1000, 1536, 8000])
def test_descent_plan_fits_the_card(codec, d):
    elem = tops._ELEM_BYTES[codec]
    vec = int(d * elem % 16 == 0)
    for m in (1, 4, 5, 16, 32, 33, 64, 128):
        threads, ring, smem, per_sm = tops._descent_plan(d, codec, m, vec)
        assert threads == 32 * -(-m // 4) <= 1024
        assert smem <= 232_448
        assert smem == tops._descent_layout_bytes(d, elem, m, ring)
        fits = tops._descent_layout_bytes(d, elem, m, 1) <= 232_448
        assert ring == int(bool(vec) and fits)
        assert 1 <= per_sm <= 32
        assert per_sm * threads <= 2048
        assert per_sm * (smem + 1024) <= 233_472


def test_descent_plan_served_and_build_shapes():
    # the served index (M 16) and the bulk build (M 5) at D 384: every
    # row of a hop in the ring, and the build's B 1024 queries all
    # resident at once on 132 SMs
    assert tops._descent_plan(384, "fp32", 16, 1) == (128, 1, 25_488, 8)
    threads, ring, smem, per_sm = tops._descent_plan(384, "fp32", 5, 1)
    assert (threads, ring) == (64, 1) and 132 * per_sm >= 1024
    assert tops._descent_plan(384, "int8", 16, 1)[:2] == (128, 1)
    # misaligned or odd rows are read from global memory
    assert tops._descent_plan(30, "fp32", 16, 0)[1] == 0


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [129, 200, 256])
def test_descent_plan_serves_past_128_slots(codec, m):
    """Past M 128 the block keeps its 32 warps, which take the list in
    rounds of 128 slots; the ring holds the hop's rows while M of them
    fit (bf16 and int8 at D 384), else they are read from global
    memory (fp32 past M 129)."""
    elem = tops._ELEM_BYTES[codec]
    threads, ring, smem, per_sm = tops._descent_plan(384, codec, m, 1)
    assert threads == 1024
    assert ring == int(tops._descent_layout_bytes(384, elem, m, 1)
                       <= 232_448)
    assert smem == tops._descent_layout_bytes(384, elem, m, ring)
    assert smem <= 232_448 and per_sm >= 1
    assert ring == int(codec != "fp32" or m == 129)


def test_descent_plan_limit_is_the_list_in_shared_memory():
    # the widest list: M ids and M scales beside the mbarrier and the
    # warps' bests; any D serves, its rows read from global memory
    m = tops.DESCENT_MAX_M
    assert m == 28_956
    assert tops._descent_plan(60_000, "fp32", m, 1)[:3] == (1024, 0,
                                                            232_432)
    assert tops._descent_plan(60_000, "fp32", 16, 1)[:2] == (128, 0)


@pytest.mark.parametrize("m", [0, 28_957])       # past DESCENT_MAX_M
def test_descent_plan_raises_on_what_no_block_holds(m):
    with pytest.raises(ValueError, match="M"):
        tops._descent_plan(384, "fp32", m, 1)


def _pairs_written(b, k, plan):
    """The (b, k) pairs each warp of a ``gather_distance`` launch writes,
    as the kernel maps them: -> a list with one entry a write."""
    threads, blocks = plan
    groups = -(-k // 4)
    out = []
    for g in range(blocks * threads // 32):
        if g >= b * groups:
            continue
        bq, k0 = divmod(g, groups)
        out.extend((bq, k0 * 4 + j) for j in range(min(4, k - k0 * 4)))
    return out


@pytest.mark.parametrize("b,k", [(8, 16), (1024, 5), (1024, 32), (1, 1),
                                 (33, 17), (300, 6), (40, 64), (7, 1000)])
def test_gather_plan_writes_every_pair_once(b, k):
    plan = tops._gather_plan(b, k, 132)
    threads, blocks = plan
    assert threads % 32 == 0 and 32 <= threads <= 256
    written = _pairs_written(b, k, plan)
    assert len(written) == b * k
    assert sorted(written) == [(i, j) for i in range(b) for j in range(k)]


def test_gather_plan_served_and_build_shapes():
    # the served hop (B 8, K 16): 32 one-warp blocks; the build's (B 1024,
    # K 5): 2,048 warps, 8 a block; B 1024 x K 32: one 8-warp block a query
    assert tops._gather_plan(8, 16, 132) == (32, 32)
    assert tops._gather_plan(1024, 5, 132) == (256, 256)
    assert tops._gather_plan(1024, 32, 132) == (256, 1024)
