"""Port parity for HNSW bulk construction (CPU): the batched
``select_neighbors`` op, the grouped reciprocal connect, ``bulk_build``
and ``HNSW(use_bulk_build=True)``, each against ``repro`` on the same
numpy inputs.

Tolerances: construction is compared bit for bit on integer-valued rows
(int8 rows with power-of-two scales among them), whose fp32 dot products
are exact in any summation order, so numpy, XLA and PyTorch cannot
diverge: ids, adjacency, levels, entry and max level must be equal, and
selected distances equal. On random rows the bulk-built index is held to
the reference's recall floors (``tests/test_build.py``).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import dispatch as jdispatch
from repro.core import hnsw as jhnsw
from repro.core import hnsw_build as jb
from repro.core.interface import HNSW as JHNSW
from repro.kernels import ref as jref
from repro_torch.core import dispatch
from repro_torch.core import hnsw as thnsw
from repro_torch.core import hnsw_build as tb
from repro_torch.core.codec import device_rows, get_codec
from repro_torch.core.interface import HNSW
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _int_vectors(rng, n, d, lo=-4, hi=5):
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _exact10(data, q):
    vn, qn = jb.normalize_rows(data), jb.normalize_rows(q)
    return np.argsort(1.0 - qn @ vn.T, axis=1, kind="stable")[:, :10]


def _codec_rows(codec, rng, n, d):
    """Integer-valued rows in each codec's storage form -> (port rows,
    port scales, jax rows, jax scales, decoded fp32 rows). int8 rows carry
    power-of-two scales, so every decoded product stays exact."""
    x = _int_vectors(rng, n, d)
    if codec == "int8":
        enc = x.astype(np.int8)
        scales = rng.choice(np.float32([0.5, 1.0, 2.0]), size=n)
        scales = scales.astype(np.float32)
        dec = x * scales[:, None]
    else:
        enc, scales = get_codec(codec).encode(x)
        dec = x
    tscl = None if scales is None else torch.from_numpy(scales)
    jenc = jcodec.get_codec(codec).encode(x)[0] if codec == "bf16" else enc
    jscl = None if scales is None else jnp.asarray(scales)
    return device_rows(enc, "cpu"), tscl, jnp.asarray(jenc), jscl, dec


# ---------------------------------------------------------------- select op
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_select_neighbors_matches_reference_and_host_oracle(codec, metric):
    """-1 padding, a fully invalid row, heavy duplication, and C < m."""
    rng = np.random.default_rng(3)
    n, d, b, c, m = 80, 16, 64, 24, 8
    rows, scl, jrows, jscl, dec = _codec_rows(codec, rng, n, d)
    q = _int_vectors(rng, b, d)
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    cand[0] = -1                                   # fully invalid row
    cand[1, 5:] = cand[1, 4]                       # heavy duplication
    for cc in (cand, cand[:, :3]):                 # C >= m and C < m
        ti, td = tops.select_neighbors(rows, torch.from_numpy(q),
                                       torch.from_numpy(np.array(cc)), m=m,
                                       metric=metric, scales=scl)
        ji, jd = jref.select_neighbors_ref(jrows, jnp.asarray(q),
                                           jnp.asarray(cc), m=m,
                                           metric=metric, scales=jscl)
        assert ti.shape == (b, m) and ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert (ti[0] == -1).all()
        for j in range(b):
            cj = cc[j][cc[j] >= 0]
            cd = list(zip(jb._dist(metric, q[j], dec[cj]),
                          [int(x) for x in cj]))
            want = tb.select_heuristic_host(metric, dec, q[j], cd, m)
            got = ti[j][ti[j] >= 0].numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(j))


def test_select_neighbors_refuses_tf32_on_the_card_only():
    """The op needs full-fp32 matmuls; on the CPU the flag is moot."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(_int_vectors(rng, 20, 8))
    cand = torch.from_numpy(rng.integers(-1, 20, size=(3, 6)).astype(
        np.int32))
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ids, _ = tops.select_neighbors(v, v[:3], cand, m=4, metric="l2")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    want, _ = tref.select_neighbors_ref(v, v[:3], cand, m=4, metric="l2")
    assert torch.equal(ids, want)


# ------------------------------------------------------- reciprocal connect
def _random_builders(seed, n=60, d=12, M=4, metric="l2"):
    """The same random graph as a reference and a port SequentialBuilder."""
    rng = np.random.default_rng(seed)
    vec = _int_vectors(rng, n, d)
    levels = rng.integers(0, 3, size=n)
    out = []
    for mod in (jb, tb):
        b = mod.SequentialBuilder(d, M=M, ef_construction=16, metric=metric,
                                  capacity=n, max_level_cap=4, seed=0)
        b.vectors[:n] = vec
        b.levels[:n] = levels
        b.n, b.entry, b.max_level = n, 0, int(levels.max())
        out.append(b)
    r = np.random.default_rng(seed + 1)
    for node in range(n):
        nb0 = r.choice(n, size=r.integers(0, 2 * M + 1), replace=False)
        ups = []
        for lc in range(1, int(levels[node]) + 1):
            el = np.flatnonzero(levels >= lc)
            ups.append((lc, r.choice(el, size=min(len(el),
                                                  r.integers(0, M + 1)),
                                     replace=False)))
        for b in out:
            b.neighbors0[node, : len(nb0)] = nb0
            for lc, up in ups:
                b.upper[lc - 1, node, : len(up)] = up
    return out


@pytest.mark.parametrize("trial", range(3))
def test_connect_reciprocal_op_host_and_reference_bit_identical(trial):
    """impl='op' == impl='host' in the port, and both == the reference,
    on random graphs and random back-edge lists (both layers, shared
    destinations)."""
    rng = np.random.default_rng(11 + trial)
    jbld, tb1 = _random_builders(100 + trial)
    tb2 = copy.deepcopy(tb1)
    n = tb1.n
    e_dst = rng.integers(0, n, size=40).astype(np.int32)
    e_lay = np.minimum(rng.integers(0, 3, size=40),
                       tb1.levels[e_dst]).astype(np.int32)
    e_src = rng.integers(0, n, size=40).astype(np.int32)
    keep = e_src != e_dst
    e_src, e_dst, e_lay = e_src[keep], e_dst[keep], e_lay[keep]
    d1 = tb._connect_reciprocal(tb1, e_src, e_dst, e_lay,
                                dev_vectors=torch.from_numpy(tb1.vectors),
                                impl="op")
    d2 = tb._connect_reciprocal(tb2, e_src, e_dst, e_lay, impl="host")
    dj = jb._connect_reciprocal(jbld, e_src, e_dst, e_lay,
                                dev_vectors=jnp.asarray(jbld.vectors),
                                impl="op")
    assert sorted(d1) == sorted(d2) == sorted(dj)
    for b in (tb2, jbld):
        np.testing.assert_array_equal(tb1.neighbors0, b.neighbors0)
        np.testing.assert_array_equal(tb1.upper, b.upper)


# ------------------------------------------------------------ build parity
@pytest.mark.parametrize("n,batch", [(600, 650),   # batch > N
                                     (600, 250),   # non-divisible tail
                                     (601, 200)])  # 1-row tail
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bulk_build_bit_identical_to_reference(n, batch, metric):
    """Integer-valued rows: adjacency, levels, entry and max level equal
    the reference's bit for bit; so does the h2d byte count."""
    data = _int_vectors(np.random.default_rng(n + batch), n, 32)
    kw = dict(M=8, ef_construction=40, seed=1, bootstrap=64,
              batch_size=batch, metric=metric)
    jdispatch.reset("hnsw.h2d_bytes")
    gj = jb.bulk_build(data, **kw)
    dispatch.reset("hnsw.h2d_bytes")
    gt = tb.bulk_build(data, device="cpu", **kw)
    for name in ("vectors", "neighbors0", "upper", "levels"):
        a, b = getattr(gt, name), getattr(gj, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (gt.entry, gt.max_level, gt.n) == (gj.entry, gj.max_level, gj.n)
    assert dispatch.get("hnsw.h2d_bytes") == jdispatch.get("hnsw.h2d_bytes")
    # on the CPU no kernel ran, and nothing counted one
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)


@pytest.mark.parametrize("n,batch", [(600, 650),   # batch > N
                                     (600, 250),   # non-divisible tail
                                     (601, 200)])  # 1-row tail
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bulk_build_legacy_bit_identical_to_reference(n, batch, metric):
    """The legacy builder (bootstrap-capped candidates, a zero-padded tail
    batch, a full upload and host connect loops every batch) on
    test_bulk_build_bit_identical_to_reference's rows: graph and h2d
    bytes equal the reference's."""
    data = _int_vectors(np.random.default_rng(n + batch), n, 32)
    kw = dict(M=8, ef_construction=40, seed=1, bootstrap=64,
              batch_size=batch, metric=metric)
    jdispatch.reset("hnsw.h2d_bytes")
    gj = jb.bulk_build_legacy(data, **kw)
    dispatch.reset()
    gt = tb.bulk_build_legacy(data, device="cpu", **kw)
    for name in ("vectors", "neighbors0", "upper", "levels"):
        a, b = getattr(gt, name), getattr(gj, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (gt.entry, gt.max_level, gt.n) == (gj.entry, gj.max_level, gj.n)
    batches = -(-(n - 64) // batch)
    assert dispatch.get("hnsw.search_graph") == batches
    assert dispatch.get("hnsw.h2d_bytes") == jdispatch.get("hnsw.h2d_bytes")
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)


def test_bulk_build_legacy_uploads_and_refuses_missing_card(monkeypatch):
    """tests/test_build.py's traffic check: the resident build moves under
    half the legacy build's bytes, and the legacy count is the
    reference's on the same rows. Without a card the default device
    raises."""
    data = np.random.default_rng(0).normal(size=(1000, 16)).astype(
        np.float32)
    kw = dict(M=4, ef_construction=20, seed=0, bootstrap=32, batch_size=64)
    dispatch.reset("hnsw.h2d_bytes")
    tb.bulk_build(data, device="cpu", **kw)
    blk = dispatch.get("hnsw.h2d_bytes")
    dispatch.reset("hnsw.h2d_bytes")
    g_leg = tb.bulk_build_legacy(data, device="cpu", **kw)
    leg = dispatch.get("hnsw.h2d_bytes")
    assert blk < leg / 2, (blk, leg)
    jdispatch.reset("hnsw.h2d_bytes")
    jg = jb.bulk_build_legacy(data, **kw)
    assert leg == jdispatch.get("hnsw.h2d_bytes")
    np.testing.assert_array_equal(g_leg.levels, jg.levels)
    assert g_leg.max_level <= 12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.bulk_build_legacy(data[:40], **kw)


def test_bulk_build_deterministic_and_connect_impls_agree():
    """Same inputs -> the same graph (the replay contract), and the host
    connect oracle gives the vectorized op's graph end to end."""
    data = np.random.default_rng(5).normal(size=(400, 24)).astype(
        np.float32)
    kw = dict(M=6, ef_construction=30, seed=3, bootstrap=32, batch_size=128,
              device="cpu")
    g1 = tb.bulk_build(data, **kw)
    g2 = tb.bulk_build(data, **kw)
    g3 = tb.bulk_build(data, connect_impl="host", **kw)
    for ga, gb in ((g1, g2), (g1, g3)):
        np.testing.assert_array_equal(ga.neighbors0, gb.neighbors0)
        np.testing.assert_array_equal(ga.upper, gb.upper)
        np.testing.assert_array_equal(ga.levels, gb.levels)
        assert (ga.entry, ga.max_level) == (gb.entry, gb.max_level)
    with pytest.raises(ValueError, match="connect_impl"):
        tb.bulk_build(data, connect_impl="loop", **kw)


def test_bulk_build_levels_and_max_level_cap():
    """Levels come from SequentialBuilder's numpy stream; max_level_cap
    clips them."""
    data = np.random.default_rng(6).normal(size=(500, 16)).astype(
        np.float32)
    g_seq = tb.build_sequential(data, M=4, ef_construction=20, seed=5)
    g_blk = tb.bulk_build(data, M=4, ef_construction=20, seed=5,
                          bootstrap=16, batch_size=128, device="cpu")
    np.testing.assert_array_equal(g_blk.levels, g_seq.levels)
    g_cap = tb.bulk_build(data, M=4, ef_construction=20, seed=5,
                          bootstrap=16, batch_size=128, max_level_cap=1,
                          device="cpu")
    np.testing.assert_array_equal(g_cap.levels, np.minimum(g_seq.levels, 1))
    assert g_cap.max_level <= 1


def test_adjacency_updates_copy_only_int32_rows():
    """apply_adjacency_updates moves one row's adjacency, leaves vectors
    alone, and counts the reference's bytes."""
    data = np.random.default_rng(7).normal(size=(200, 16)).astype(
        np.float32)
    g = tb.build_sequential(data, M=4, ef_construction=20, seed=0)
    dispatch.reset("hnsw.h2d_bytes")
    dg = thnsw.to_device_graph(g, device="cpu")
    lmax = g.upper.shape[0]
    assert dispatch.get("hnsw.h2d_bytes") == 200 * (16 * 4 + 4 * 8
                                                    + 4 * lmax * 4 + 4)
    g.neighbors0[7] = -1
    g.neighbors0[7, 0] = 3
    before = dg.vectors.clone()
    dispatch.reset("hnsw.h2d_bytes")
    thnsw.apply_adjacency_updates(dg, g, [7])
    assert dispatch.get("hnsw.h2d_bytes") == 4 * (8 + lmax * 4)
    row = dg.neighbors0[7]
    assert row[0] == 3 and bool((row[1:] == -1).all())
    assert torch.equal(dg.vectors, before)


# ------------------------------------------------- HNSW(use_bulk_build=True)
@pytest.mark.parametrize("dtype,floor", [("fp32", 0.85), ("int8", 0.75)])
def test_hnsw_bulk_build_recall_and_appends(dtype, floor):
    """Bulk adoption through the index at the reference's recall floors
    (tests/test_build.py), the reference's recall within 0.02, and appends
    after adoption."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(400, 24)).astype(np.float32)
    q = rng.normal(size=(30, 24)).astype(np.float32)
    true10 = _exact10(data, q)
    keys = [f"d{i}" for i in range(len(data))]
    recall = {}
    for name, make in (("port", lambda: HNSW(M=8, ef_construction=40,
                                             use_bulk_build=True,
                                             dtype=dtype, device="cpu")),
                       ("ref", lambda: JHNSW(M=8, ef_construction=40,
                                             use_bulk_build=True,
                                             dtype=dtype))):
        idx = make()
        idx.bulk_insert(keys, data)
        got, _ = idx.query_batch(q, k=10)
        ids = np.asarray([[int(k[1:]) if k is not None else -1 for k in row]
                          for row in got])
        recall[name] = jhnsw.recall_at_k(ids, true10)
        idx.insert("extra", rng.normal(size=24).astype(np.float32))
        assert idx.size == len(data) + 1
        k2, _ = idx.query(rng.normal(size=24).astype(np.float32), k=5)
        assert len(k2) == 5
        if name == "port":
            assert idx.config_dict()["use_bulk_build"] is True
            assert idx.storage_dtype == dtype
            assert idx._builder.n == len(data) + 1
            if dtype == "int8":
                assert idx._enc.shape == (len(data) + 1, 24)
                assert idx._device_graph.vectors.dtype == torch.int8
    assert recall["port"] >= floor, recall
    assert abs(recall["port"] - recall["ref"]) <= 0.02, recall


def test_hnsw_bulk_build_matches_reference_int8_state():
    """A bulk-built int8 index holds the reference's encoded rows, scales
    and graph, and uploads the same bytes."""
    data = _int_vectors(np.random.default_rng(8), 300, 16)
    keys = [f"d{i}" for i in range(300)]
    t = HNSW(distance_function="l2", M=6, ef_construction=30,
             use_bulk_build=True, dtype="int8", device="cpu")
    j = JHNSW(distance_function="l2", M=6, ef_construction=30,
              use_bulk_build=True, dtype="int8")
    t.bulk_insert(keys, data)
    j.bulk_insert(keys, data)
    np.testing.assert_array_equal(t._enc, j._enc)
    np.testing.assert_array_equal(t._scales, j._scales)
    tg, jg = t.host_graph(), j._builder.graph_full_capacity(12)
    for name in ("vectors", "neighbors0", "upper", "levels"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)
    q = _int_vectors(np.random.default_rng(9), 6, 16)
    dispatch.reset("hnsw.h2d_bytes")
    jdispatch.reset("hnsw.h2d_bytes")
    kt, dt = t.query_batch(q, k=5)
    kj, dj = j.query_batch(q, k=5)
    assert kt == kj
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=1e-6, atol=1e-6)
    assert dispatch.get("hnsw.h2d_bytes") == jdispatch.get("hnsw.h2d_bytes")
