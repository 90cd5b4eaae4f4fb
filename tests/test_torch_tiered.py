"""Port parity for the tiered backend (CPU): ``TieredVectorStore``,
``simulate_search_traffic``, ``auto_prefetch_p`` and ``TieredIndex``
against ``repro/core/tiered.py``.

The tiered search is host numpy over the host HNSW graph in both
packages, and the sequential builder is a copy of the reference's, so
keys, distances and ``TierStats`` must be equal, bit for bit. Only
``exact_query`` runs a kernel's plain version (``distance_topk``): keys
equal, distances within 1e-5.
"""
import numpy as np
import pytest

from repro.core import make_index as jmake_index
from repro.core import tiered as jtiered
from repro.data.synthetic import make_corpus
from repro_torch.core import tiered as ttiered
from repro_torch.core.codec import get_codec
from repro_torch.core.index import make_index as tmake_index

CODECS = ["fp32", "bf16", "int8"]


def test_tiered_lru_eviction_and_counters():
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    st = ttiered.TieredVectorStore(data, cache_rows=4, prefetch_p=1)
    st.read([0, 1, 2, 3])
    assert st.stats.misses == 4 and st.stats.hits == 0
    st.read([0])
    assert st.stats.hits == 1
    st.read([4, 5])                      # evicts 1, 2 (LRU; 0 was touched)
    assert st.stats.evictions == 2
    got = st.read([7])
    np.testing.assert_array_equal(got[0], data[7])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("p", [1, 3, None])
def test_store_reads_and_counters_match_jax(codec, p):
    """The same reads, with and without graph prefetch, through both
    packages' stores: equal rows, equal counters, equal cache order."""
    from repro.core.codec import get_codec as jget_codec
    rng = np.random.default_rng(1)
    data = rng.normal(size=(60, 8)).astype(np.float32)
    nbrs = rng.integers(-1, 60, size=(60, 6))
    stores = [jtiered.TieredVectorStore(data, cache_rows=9, prefetch_p=p,
                                        codec=jget_codec(codec)),
              ttiered.TieredVectorStore(data, cache_rows=9, prefetch_p=p,
                                        codec=get_codec(codec))]
    assert stores[0].p == stores[1].p
    assert stores[0].slow_tier_bytes == stores[1].slow_tier_bytes
    fn = lambda i: nbrs[i]
    for step in range(12):
        ids = rng.integers(0, 60, size=5)
        got = [s.read(ids, fn if step % 2 else None) for s in stores]
        assert got[0].tobytes() == got[1].tobytes()
    assert stores[1].stats.as_dict() == stores[0].stats.as_dict()
    assert list(stores[0].cache) == list(stores[1].cache)


def test_auto_prefetch_p_matches_jax():
    for dim in (4, 64, 384, 1536, 1 << 19):
        for itemsize in (1, 2, 4):
            assert (ttiered.auto_prefetch_p(dim, itemsize)
                    == jtiered.auto_prefetch_p(dim, itemsize))
    assert ttiered.auto_prefetch_p(384) < ttiered.auto_prefetch_p(64)


@pytest.mark.parametrize("prefetch", [True, False])
def test_simulate_search_traffic_matches_jax(prefetch):
    jidx = jmake_index("hnsw", metric="cosine", M=8, ef_construction=40)
    data = make_corpus(300, 16, seed=2)
    jidx.bulk_insert([f"d{i}" for i in range(300)], data)
    g = jidx._builder.graph()
    q = make_corpus(20, 16, seed=3)
    kw = dict(ef=24, cache_rows=32, prefetch_p=4,
              use_graph_prefetch=prefetch)
    assert (ttiered.simulate_search_traffic(g, q, **kw).as_dict()
            == jtiered.simulate_search_traffic(g, q, **kw).as_dict())


def test_slow_tier_is_encoded():
    data = make_corpus(200, 32, seed=14)
    keys = [f"d{i}" for i in range(200)]
    stores = {}
    for dtype in ("fp32", "int8"):
        idx = tmake_index("tiered", device="cpu", metric="cosine", M=8,
                          ef_construction=40, cache_rows=64, dtype=dtype)
        idx.bulk_insert(keys, data)
        idx.query(data[0], 5)
        _, store = idx._tiers()
        stores[dtype] = store
        assert idx.stats.transactions > 0
    assert (stores["fp32"].slow_tier_bytes
            / stores["int8"].slow_tier_bytes) >= 3.5
    assert stores["int8"].p == ttiered.auto_prefetch_p(32, 1)
    assert stores["int8"].p == 4 * stores["fp32"].p


def _pair(dtype, metric="cosine", **kw):
    cfg = dict(metric=metric, M=8, ef_construction=40, ef_search=24,
               cache_rows=48, dtype=dtype, **kw)
    return (jmake_index("tiered", **cfg),
            tmake_index("tiered", device="cpu", **cfg))


def _assert_same(j, t, q, k=5):
    jk, jd = j.query_batch(q, k)
    tk, td = t.query_batch(q, k)
    assert tk == jk
    assert np.asarray(td).tobytes() == np.asarray(jd).tobytes()
    assert t.stats.as_dict() == j.stats.as_dict()


@pytest.mark.parametrize("dtype", CODECS)
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_tiered_index_matches_jax(dtype, metric):
    """The same inserts, updates and deletes: equal keys, distances,
    TierStats, state and epochs."""
    j, t = _pair(dtype, metric)
    data = make_corpus(160, 16, seed=4)
    extra = make_corpus(6, 16, seed=5)
    q = make_corpus(12, 16, seed=6)
    assert t.config_dict() == j.config_dict()
    for idx in (j, t):
        idx.bulk_insert([f"d{i}" for i in range(160)], data)
    _assert_same(j, t, q)
    _assert_same(j, t, q[:3], k=9)             # stats accumulate
    for idx in (j, t):
        idx.insert("solo", extra[0])
        idx.update("d3", extra[1])
        idx.delete("d7")
        idx.delete("d70")
    _assert_same(j, t, q)                      # tiers re-warmed
    assert "d7" not in sum(t.query_batch(data[5:9], 8)[0], [])
    assert t.mutation_epoch == j.mutation_epoch
    assert t.keys() == j.keys() and t.size == j.size
    ja, jm = j.state_dict()
    ta, tm = t.state_dict()
    assert jm["outer_epoch"] == tm["outer_epoch"]
    for name in ja:
        assert np.asarray(ja[name]).tobytes() == np.asarray(
            ta[name]).tobytes(), name
    jk, jd = j.exact_query(q, 4)
    tk, td = t.exact_query(q, 4)
    assert tk == jk
    np.testing.assert_allclose(np.asarray(td), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_tiered_compact_and_restore_match_jax(tmp_path):
    j, t = _pair("int8")
    data = make_corpus(120, 16, seed=7)
    q = make_corpus(8, 16, seed=8)
    for idx in (j, t):
        idx.bulk_insert([f"d{i}" for i in range(120)], data)
        for i in range(0, 120, 9):
            idx.delete(f"d{i}")
        idx.compact()
    _assert_same(j, t, q)
    p = str(tmp_path / "tiered.npz")
    t.export(p)
    from repro_torch.core.index import VectorIndex
    back = VectorIndex.load(p, device="cpu")
    assert isinstance(back, ttiered.TieredIndex)
    assert back.mutation_epoch == t.mutation_epoch
    assert back.query_batch(q, 5)[0] == t.query_batch(q, 5)[0]


def test_tiered_empty_and_sharded_raise():
    """An empty index raises at search, at one shard and at 2 (sharding
    is ported; the name is kept from when it raised)."""
    for s in (1, 2):
        with pytest.raises(ValueError, match="index is empty"):
            tmake_index("tiered", device="cpu", n_shards=s).query(
                np.ones(4, np.float32), 3)
