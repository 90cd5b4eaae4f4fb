"""Port parity for the HNSW retrieval core (CPU): the numpy builder, the
lock-step search with both layer-0 beam implementations, and the keyed
``HNSW`` index, each against ``repro`` on the same inputs.

Tolerances: the builder is numpy in both packages, so its graphs must be
bit-identical. Search ids must match exactly on integer-valued l2 inputs
(exact fp32 arithmetic in both frameworks); cosine search is held to the
reference's recall@10 within 0.01; distances agree to atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro.core import hnsw as jhnsw
from repro.core import hnsw_build as jbuild
from repro.core import make_index as jmake_index
from repro.data.synthetic import make_corpus
from repro_torch.core import dispatch
from repro_torch.core import hnsw as thnsw
from repro_torch.core import hnsw_build as tbuild
from repro_torch.core.index import make_index as tmake_index
from repro_torch.convert import device_graph_from_host


@pytest.fixture(scope="module")
def int_graph():
    """Integer-valued rows + an l2 graph built by the reference builder."""
    rng = np.random.default_rng(0)
    vec = rng.integers(-3, 4, size=(400, 8)).astype(np.float32)
    q = rng.integers(-3, 4, size=(16, 8)).astype(np.float32)
    g = jbuild.build_sequential(vec, M=6, ef_construction=40, metric="l2",
                                seed=3)
    return g, q


@pytest.fixture(scope="module")
def cos_graph():
    data = make_corpus(500, 16, seed=1)
    q = make_corpus(32, 16, seed=2)
    g = jbuild.build_sequential(data, M=8, ef_construction=60,
                                metric="cosine", seed=0)
    return g, q, data


def test_sequential_builder_bit_identical():
    data = make_corpus(300, 16, seed=4)
    kw = dict(M=8, ef_construction=50, metric="cosine", seed=7)
    jg = jbuild.build_sequential(data, **kw)
    tg = tbuild.build_sequential(data, **kw)
    for name in ("vectors", "neighbors0", "upper", "levels"):
        a, b = getattr(tg, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tg.entry, tg.max_level, tg.n) == (jg.entry, jg.max_level, jg.n)


def test_sequential_builder_journal_and_capacity_view_identical():
    data = make_corpus(40, 8, seed=5)
    jb = jbuild.SequentialBuilder(8, M=4, ef_construction=20, seed=1)
    tb = tbuild.SequentialBuilder(8, M=4, ef_construction=20, seed=1)
    for v in data:
        jb.insert(v)
        tb.insert(v)
    assert jb.journal == tb.journal
    jv, tv = jb.graph_full_capacity(12), tb.graph_full_capacity(12)
    np.testing.assert_array_equal(tv.upper, jv.upper)
    np.testing.assert_array_equal(tv.neighbors0, jv.neighbors0)
    # adopting a graph keeps appending identically
    ja = jbuild.SequentialBuilder.from_graph(jb.graph(), seed=2)
    ta = tbuild.SequentialBuilder.from_graph(tb.graph(), seed=2)
    extra = make_corpus(5, 8, seed=6)
    for v in extra:
        assert ja.insert(v) == ta.insert(v)
    np.testing.assert_array_equal(ta.neighbors0, ja.neighbors0)
    cand = [(0.5, 1), (0.25, 2), (0.25, 3), (0.9, 4), (0.5, 1)]
    np.testing.assert_array_equal(
        tbuild.select_heuristic_host("cosine", tb.vectors, tb.vectors[0],
                                     cand, 3),
        jbuild.select_heuristic_host("cosine", jb.vectors, jb.vectors[0],
                                     cand, 3))


@pytest.mark.parametrize("beam_impl", ["fused", "jnp"])
@pytest.mark.parametrize("max_iters", [None, 0])
def test_search_graph_ids_exact_on_integer_l2(int_graph, beam_impl,
                                              max_iters):
    g, q = int_graph
    kw = dict(k=8, ef=16, beam_impl=beam_impl, max_iters=max_iters)
    ji, jd = jhnsw.search_graph(jhnsw.to_device_graph(g), q, **kw)
    ti, td = thnsw.search_graph(device_graph_from_host(g, device="cpu"), q,
                                **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def _wide_graph(n=2000, d=32, m=130, layers=2, seed=11):
    """A random HNSW graph at M 130 (2M 260: a T 4 hop is 1,040
    candidates) over integer-valued rows: layer-0 lists [N, 2M] and
    upper lists [2, N, M] of random ids with 15 % -1 padding."""
    rng = np.random.default_rng(seed)
    vec = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    nb0 = rng.integers(0, n, size=(n, 2 * m)).astype(np.int32)
    nb0[rng.random(nb0.shape) < 0.15] = -1
    up = rng.integers(0, n, size=(layers, n, m)).astype(np.int32)
    up[rng.random(up.shape) < 0.15] = -1
    levels = rng.integers(0, layers + 1, size=n).astype(np.int32)
    entry = int(np.flatnonzero(levels == layers)[0])
    g = jbuild.HNSWGraph(vectors=vec, neighbors0=nb0, upper=up,
                         levels=levels, entry=entry, max_level=layers,
                         metric="l2", n=n)
    q = rng.integers(-3, 4, size=(16, d)).astype(np.float32)
    return g, q


@pytest.mark.parametrize("beam_impl", ["fused", "jnp"])
@pytest.mark.parametrize("beam_expand", [None, 1])
def test_search_graph_at_m130_matches_reference(beam_impl, beam_expand):
    """M 130 on 2,000 x 32 rows: the port's search (its descent over
    130-slot upper lists, its beam over 260-slot layer-0 lists) returns
    the reference's ids and distances."""
    g, q = _wide_graph()
    assert g.M == 130
    kw = dict(k=10, ef=32, beam_impl=beam_impl, beam_expand=beam_expand)
    ji, jd = jhnsw.search_graph(jhnsw.to_device_graph(g), q, **kw)
    ti, td = thnsw.search_graph(device_graph_from_host(g, device="cpu"), q,
                                **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


@pytest.mark.parametrize("beam_impl", ["fused", "jnp"])
def test_search_graph_cosine_recall_matches(cos_graph, beam_impl):
    g, q, data = cos_graph
    v = jbuild.normalize_rows(data)
    qn = jbuild.normalize_rows(q)
    exact = np.argsort(1.0 - qn @ v.T, axis=1, kind="stable")[:, :10]
    ji, _ = jhnsw.search_graph(jhnsw.to_device_graph(g), q, k=10, ef=32,
                               beam_impl=beam_impl)
    ti, td = thnsw.search_graph(thnsw.to_device_graph(g, device="cpu"), q,
                                k=10, ef=32, beam_impl=beam_impl)
    r_j = jhnsw.recall_at_k(np.asarray(ji), exact)
    r_t = thnsw.recall_at_k(ti.numpy(), exact)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert r_t >= 0.8
    assert bool((td[:, 1:] >= td[:, :-1]).all())           # ascending


@pytest.mark.parametrize("beam_impl", ["fused", "jnp"])
def test_tombstoned_rows_never_returned(cos_graph, beam_impl):
    g, q, _ = cos_graph
    deleted = np.zeros(g.vectors.shape[0], bool)
    before, _ = thnsw.search_graph(thnsw.to_device_graph(g, device="cpu"), q,
                                   k=10, ef=32, beam_impl=beam_impl)
    victims = np.unique(before[:, :3].numpy())
    deleted[victims] = True
    deleted[g.entry] = True                      # the entry point too
    dg = thnsw.to_device_graph(g, deleted, device="cpu")
    ids, dists = thnsw.search_graph(dg, q, k=10, ef=32, beam_impl=beam_impl)
    ids = ids.numpy()
    assert not np.isin(ids, np.flatnonzero(deleted)).any()
    assert (ids[:, 0] >= 0).all()
    ji, _ = jhnsw.search_graph(jhnsw.to_device_graph(g, deleted), q, k=10,
                               ef=32, beam_impl=beam_impl)
    assert not np.isin(np.asarray(ji), np.flatnonzero(deleted)).any()


def test_search_counts_one_beam_launch_and_host_syncs(cos_graph):
    g, q, _ = cos_graph
    dg = thnsw.to_device_graph(g, device="cpu")
    dispatch.reset()
    thnsw.search_graph(dg, q, k=5, ef=16)
    assert dispatch.get("hnsw.search_graph") == 1
    assert dispatch.get("hnsw.beam_launches") == 1
    # one condition read per greedy hop, at least one per upper layer
    assert dispatch.get("hnsw.host_syncs") >= g.max_level
    # on the CPU no kernel ran
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)


# ---------------------------------------------------------------------------
# HNSW VectorIndex: the conformance sequence of tests/test_index.py
# ---------------------------------------------------------------------------
def _crud_trace(make):
    """Run tests/test_index.py's conformance key sequence on an index from
    ``make``; return what every step observed."""
    data = make_corpus(150, 16, seed=0)
    idx = make()
    out = []
    idx.bulk_insert([f"d{i}" for i in range(150)], data)
    out.append(("bulk", idx.size, idx.mutation_epoch))
    out.append(("q7",) + tuple(map(tuple, _q(idx, data[7], 5))))
    idx.insert("extra", data[7] + 0.001)
    out.append(("insert", idx.size, idx.mutation_epoch, "extra" in idx))
    keys, d = idx.query(data[:3], k=4)
    out.append(("batch", tuple(map(tuple, keys)), _r(d)))
    idx.delete("d7")
    out.append(("delete", idx.size, idx.mutation_epoch, "d7" in idx.keys()))
    out.append(("q7b",) + tuple(map(tuple, _q(idx, data[7], 5))))
    with pytest.raises(KeyError):
        idx.delete("d7")
    probe = make_corpus(1, 16, seed=99)[0]
    winner = idx.query(probe, k=1)[0][0]
    mover = "d33" if winner != "d33" else "d44"
    idx.update(mover, probe)
    out.append(("update", idx.size, idx.mutation_epoch,
                idx.query(probe, k=1)[0][0]))
    idx.bulk_insert(["a", "a", "b"], make_corpus(3, 16, seed=11))
    out.append(("dups", idx.size, idx.mutation_epoch, idx.keys()[-2:]))
    keys, d = idx.query(data[0], k=idx.size + 3)
    out.append(("all", tuple(keys), _r(d)))
    return out


def _r(d):
    """Distances rounded to 1e-4 (the frameworks' fp32 sums may differ in
    the last bits; -0.0 == 0.0 as floats)."""
    return tuple(round(float(x), 4) for x in np.ravel(d))


def _q(idx, v, k):
    keys, d = idx.query(v, k=k)
    return [keys, list(_r(d))]


def test_hnsw_crud_conformance_matches_reference():
    kw = dict(dim=16, metric="cosine", M=8, ef_construction=60, ef_search=48)
    want = _crud_trace(lambda: jmake_index("hnsw", **kw))
    got = _crud_trace(lambda: tmake_index("hnsw", device="cpu", **kw))
    assert got == want


def test_hnsw_incremental_sync_matches_full_upload():
    data = make_corpus(120, 16, seed=3)
    idx = tmake_index("hnsw", device="cpu", metric="cosine", M=8,
                      ef_construction=40)
    idx.bulk_insert([f"d{i}" for i in range(120)], data)
    idx.query(data[:4], k=5)                   # full first upload
    assert not idx._builder.journal
    for j, v in enumerate(make_corpus(5, 16, seed=4)):
        idx.insert(f"n{j}", v)
    idx.delete("d17")
    idx.query(data[:4], k=5)                   # incremental sync
    full = thnsw.to_device_graph(idx.host_graph(), idx._deleted,
                                 device="cpu")
    for name in ("vectors", "neighbors0", "upper", "levels", "deleted"):
        torch.testing.assert_close(getattr(idx._device_graph, name),
                                   getattr(full, name), rtol=0, atol=0)
    assert idx._device_graph.entry == full.entry


def test_unported_surface_raises_not_implemented(tmp_path):
    """Several shards are ported now (the name is kept from when they
    raised): every kind constructs at 2 shards, a stored 1-shard HNSW
    restores at 2, and a state recorded at 2 shards restores at 1."""
    for kind in ("ivf", "tiered", "hnsw"):
        assert tmake_index(kind, device="cpu", n_shards=2).shard_count == 2
    assert tmake_index("hnsw", device="cpu", dtype="int8",
                       n_shards=2).shard_count == 2
    assert tmake_index("ivf", device="cpu", store=str(tmp_path / "ivf"),
                       n_shards=2).shard_count == 2
    sd = str(tmp_path / "s")
    idx = tmake_index("hnsw", device="cpu", store=sd)
    idx.insert("a", np.ones(4, np.float32))
    two = tmake_index("hnsw", device="cpu", store=sd, n_shards=2)
    assert two.shard_count == 2 and two.keys() == ["a"]
    one = tmake_index("hnsw", device="cpu")
    one.restore_state(*two.state_dict())
    assert one.keys() == ["a"] and one.mutation_epoch == idx.mutation_epoch
