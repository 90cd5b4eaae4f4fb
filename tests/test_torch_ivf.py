"""Port parity for the IVF backend (CPU): ``kmeans``, ``search_ivf`` and
``IVFVectorIndex`` against ``repro/core/ivf.py`` on the same numpy
inputs.

The two packages draw k-means' initial rows from different generators
(``jax.random.choice`` against a seeded ``torch.Generator``), so parity
either gives the port the reference's draw (``init``, or ``init_rows``
patched to it) or injects the reference's trained centroids through
``restore_state``.

Tolerances: centroids and distances within 1e-5 (the two frameworks sum
fp32 products in another order); distances exact on integer-valued l2
rows. Ids, keys, lists, assignments and stored arrays (encoded bytes
included) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import ivf as jivf
from repro.core import make_index as jmake_index
from repro.data.synthetic import make_corpus
from repro_torch.core import codec as tcodec
from repro_torch.core import dispatch
from repro_torch.core import ivf as tivf
from repro_torch.core.index import make_index as tmake_index

CODECS = ["fp32", "bf16", "int8"]
METRICS = ["cosine", "l2", "ip"]


def jax_init(n, k, seed):
    """The reference's initial rows (``repro/core/ivf.py:kmeans``)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


@pytest.fixture
def reference_draw(monkeypatch):
    """The port's k-means starts from the reference's rows."""
    monkeypatch.setattr(tivf, "init_rows", jax_init)


def _clustered(n, dim, seed, n_clusters=8):
    """make_corpus rows around well separated centers: no row lies near
    the boundary of two clusters, so both packages assign alike."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 6
    x = make_corpus(n, dim, n_clusters=n_clusters, seed=seed)
    return x + centers[rng.integers(0, n_clusters, n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tol(metric):
    return dict(rtol=1e-5, atol=1e-5) if metric == "l2" else dict(
        rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# kmeans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_matches_jax_from_the_same_init(seed):
    x = _clustered(600, 24, seed)
    jc, ja = jivf.kmeans(jnp.asarray(x), 8, 8, seed)
    tc, ta = tivf.kmeans(_t(x), 8, 8, seed, init=jax_init(600, 8, seed))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)


def test_kmeans_exact_on_integer_rows():
    """Integer rows: every per-cluster sum is exact and the mean one
    correctly rounded division, so the centroids are equal bit for
    bit."""
    rng = np.random.default_rng(5)
    centers = rng.integers(-40, 41, size=(6, 16)) * 4
    x = (centers[rng.integers(0, 6, 300)]
         + rng.integers(-3, 4, size=(300, 16))).astype(np.float32)
    jc, ja = jivf.kmeans(jnp.asarray(x), 6, 8, 1)
    tc, ta = tivf.kmeans(_t(x), 6, 8, 1, init=jax_init(300, 6, 1))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert tc.numpy().tobytes() == np.asarray(jc).tobytes()


def test_kmeans_draw_is_seeded_and_distinct():
    a, b = tivf.init_rows(50, 20, 3), tivf.init_rows(50, 20, 3)
    assert torch.equal(a, b) and len(set(a.tolist())) == 20
    assert not torch.equal(a, tivf.init_rows(50, 20, 4))
    c1, a1 = tivf.kmeans(_t(_clustered(200, 8, 2)), 5, 4, seed=9)
    c2, a2 = tivf.kmeans(_t(_clustered(200, 8, 2)), 5, 4, seed=9)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


def test_lists_are_the_reference_loop():
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 7, 500)
    assign[assign == 3] = 2                       # an empty list
    nlist = 7
    counts = np.bincount(assign, minlength=nlist)
    want = np.full((nlist, int(counts.max())), -1, np.int32)
    cursor = np.zeros(nlist, np.int64)
    for i, a in enumerate(assign):
        want[a, cursor[a]] = i
        cursor[a] += 1
    np.testing.assert_array_equal(tivf._lists(assign, nlist), want)


# ---------------------------------------------------------------------------
# search_ivf on the reference's packed index
# ---------------------------------------------------------------------------
def _pair(metric, codec, n=500, dim=32, nlist=16, seed=0, rows=None,
          integer=False):
    """A reference ``build_ivf`` and the port's ``IVFIndex`` of the same
    rows, centroids and lists, the rows encoded by each package's codec
    (``integer``: int8 rows as themselves with scales 1.0, as bf16 holds
    small integers, so that distances stay exact)."""
    x = rows if rows is not None else make_corpus(n, dim, seed=seed)
    jidx = jivf.build_ivf(x, nlist=nlist, metric=metric)
    v = np.asarray(jidx.vectors)
    jenc, jscl = jcodec.get_codec(codec).encode(v)
    tenc, tscl = tcodec.get_codec(codec).encode(v)
    if integer and codec == "int8":
        jenc = tenc = v.astype(np.int8)
        jscl = tscl = np.ones(v.shape[0], np.float32)
    jidx = jivf.IVFIndex(vectors=jnp.asarray(jenc),
                         centroids=jidx.centroids, lists=jidx.lists,
                         metric=metric,
                         scales=None if jscl is None else jnp.asarray(jscl))
    tidx = tivf.IVFIndex(
        vectors=tcodec.device_rows(tenc, "cpu"),
        centroids=_t(np.asarray(jidx.centroids)),
        lists=_t(np.asarray(jidx.lists)), metric=metric,
        scales=None if tscl is None else _t(tscl))
    return jidx, tidx


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("metric", METRICS)
def test_search_ivf_matches_jax(metric, codec):
    jidx, tidx = _pair(metric, codec)
    q = np.random.default_rng(1).normal(size=(9, 32)).astype(np.float32)
    for k, nprobe in ((10, 4), (5, 16), (1, 1)):
        ji, jd = jivf.search_ivf(jidx, q, k=k, nprobe=nprobe)
        ti, td = tivf.search_ivf(tidx, q, k=k, nprobe=nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   **_tol(metric))
    ji, jd = jivf.search_ivf(jidx, q[0], k=3)      # one query [D]
    ti, td = tivf.search_ivf(tidx, q[0], k=3)
    assert ti.shape == (3,)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_search_ivf_exact_on_integer_l2_rows():
    rng = np.random.default_rng(2)
    rows = rng.integers(-4, 5, size=(400, 16)).astype(np.float32)
    q = rng.integers(-4, 5, size=(7, 16)).astype(np.float32)
    for codec in CODECS:
        jidx, tidx = _pair("l2", codec, nlist=8, rows=rows, integer=True)
        ji, jd = jivf.search_ivf(jidx, q, k=12, nprobe=3)
        ti, td = tivf.search_ivf(tidx, q, k=12, nprobe=3)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_ties_go_to_the_lower_slot():
    """Repeated rows and repeated centroids: equal distances keep the
    lower list slot and the lower centroid, as ``lax.top_k``."""
    rng = np.random.default_rng(3)
    base = rng.integers(-2, 3, size=(6, 8)).astype(np.float32)
    rows = np.repeat(base, 5, axis=0)                        # 5 copies each
    cent = np.concatenate([base, base[:2]])                 # 2 equal pairs
    assign = np.argmin(((rows[:, None] - cent[None]) ** 2).sum(-1), 1)
    lists = tivf._lists(assign, cent.shape[0])
    jidx = jivf.IVFIndex(vectors=jnp.asarray(rows),
                         centroids=jnp.asarray(cent),
                         lists=jnp.asarray(lists), metric="l2")
    tidx = tivf.IVFIndex(vectors=_t(rows), centroids=_t(cent),
                         lists=_t(lists), metric="l2")
    q = np.concatenate([base, base[:3] + 0.5]).astype(np.float32)
    for k, nprobe in ((7, 2), (12, 8), (3, 1)):
        ji, jd = jivf.search_ivf(jidx, q, k=k, nprobe=nprobe)
        ti, td = tivf.search_ivf(tidx, q, k=k, nprobe=nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_k_clamp_and_missing_slots():
    """k past nprobe · cap is clamped; fewer live candidates than k come
    back as -1 at INF."""
    rows = make_corpus(40, 8, seed=6)
    jidx, tidx = _pair("cosine", "fp32", rows=rows, nlist=8)
    cap = tidx.lists.shape[1]
    q = rows[:3]
    for k, nprobe in ((1000, 2), (2 * cap, 1), (40, 8)):
        ji, jd = jivf.search_ivf(jidx, q, k=k, nprobe=nprobe)
        ti, td = tivf.search_ivf(tidx, q, k=k, nprobe=nprobe)
        assert ti.shape[1] == min(k, nprobe * cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
        missing = ti.numpy() < 0
        assert (td.numpy()[missing] >= 3e38).all()
    assert (tivf.search_ivf(tidx, q, k=1000, nprobe=2)[0].numpy() < 0).any()


def test_search_launches_counted_only_on_the_card():
    """On the CPU the wrapper runs the plain version and counts no
    launch."""
    _, tidx = _pair("cosine", "int8")
    dispatch.reset()
    tivf.search_ivf(tidx, make_corpus(4, 32, seed=2), k=5, nprobe=4)
    assert dispatch.get("kernel.gather_distance") == 0


# ---------------------------------------------------------------------------
# IVFVectorIndex
# ---------------------------------------------------------------------------
DATA = make_corpus(300, 16, seed=0)
EXTRA = make_corpus(12, 16, seed=1)


def _indexes(metric, dtype, nlist=8, **kw):
    cfg = dict(metric=metric, dim=16, nlist=nlist, nprobe=3, dtype=dtype,
               **kw)
    return jmake_index("ivf", **cfg), tmake_index("ivf", device="cpu", **cfg)


def _assert_state_equal(j, t, centroids=True):
    ja, jm = j.state_dict()
    ta, tm = t.state_dict()
    assert set(ja) == set(ta) and jm == tm
    for name in ja:
        if name == "centroids" and not centroids:
            continue
        x, y = np.asarray(ja[name]), np.asarray(ta[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), f"array {name!r} differs"


def _assert_answers(j, t, q, metric, k=6, **kw):
    jk, jd = j.query_batch(q, k, **kw)
    tk, td = t.query_batch(q, k, **kw)
    assert tk == jk
    np.testing.assert_allclose(np.asarray(td), np.asarray(jd), **_tol(metric))


@pytest.mark.parametrize("dtype", CODECS)
@pytest.mark.parametrize("metric", METRICS)
def test_query_batch_with_injected_centroids_matches_jax(metric, dtype):
    j, t = _indexes(metric, dtype)
    keys = [f"d{i}" for i in range(300)]
    j.bulk_insert(keys, DATA)
    t.bulk_insert(keys, DATA)
    _assert_state_equal(j, t)                  # rows and bytes, no centroids
    j.query(DATA[0], 3)                        # trains the reference
    t.restore_state(*j.state_dict())
    _assert_state_equal(j, t)
    q = DATA[::37] + 0.1
    _assert_answers(j, t, q, metric)
    _assert_answers(j, t, q, metric, nprobe=8)
    _assert_answers(j, t, q, metric, k=40, ef=99)    # ef is ignored
    jk, _ = j.exact_query(q, 5)
    tk, _ = t.exact_query(q, 5)
    assert tk == jk


@pytest.mark.parametrize("dtype", CODECS)
def test_crud_and_compact_match_jax(dtype, reference_draw):
    """Mutations after training assign on the host; compaction drops the
    centroids and the next search retrains (from the reference's draw)
    over the live rows. Rows, encoded bytes, scales, keys and epochs equal
    the reference's at every step."""
    x = _clustered(240, 16, 4)
    j, t = _indexes("cosine", dtype)
    for idx in (j, t):
        idx.bulk_insert([f"d{i}" for i in range(240)], x)
        idx.query(x[0], 3)
    np.testing.assert_allclose(t._centroids, j._centroids, atol=1e-5)
    t._centroids = j._centroids.copy()         # assignments then bit-equal
    t._invalidate()
    for idx in (j, t):
        idx.insert("solo", EXTRA[0])
        idx.update("d5", EXTRA[1])
        idx.delete("d9")
        idx.delete("d40")
        idx.insert("d7", EXTRA[2])             # upsert of a live key
    _assert_state_equal(j, t)
    _assert_answers(j, t, x[::30], "cosine")
    assert t.mutation_epoch == j.mutation_epoch
    assert t.keys() == j.keys() and t.size == j.size
    assert "d9" not in t and "solo" in t
    for idx in (j, t):
        idx.compact()
    _assert_state_equal(j, t)
    assert not t.state_dict()[1]["has_centroids"]
    _assert_answers(j, t, x[::30], "cosine")   # retrains in both
    np.testing.assert_allclose(t._centroids, j._centroids, atol=1e-5)
    assert t.mutation_epoch == j.mutation_epoch


def test_config_restore_and_export(tmp_path):
    j, t = _indexes("l2", "int8", nlist=4)
    assert t.config_dict() == j.config_dict()
    keys = [f"d{i}" for i in range(300)]
    t.bulk_insert(keys, DATA)
    t.query(DATA[0], 3)
    p = str(tmp_path / "ivf.npz")
    t.export(p)
    from repro_torch.core.index import VectorIndex
    back = VectorIndex.load(p, device="cpu")
    assert type(back) is type(t)
    _assert_state_equal(t, back)
    assert back.query_batch(DATA[:4], 5)[0] == t.query_batch(DATA[:4], 5)[0]
    with pytest.raises(ValueError, match="cannot replay"):
        t._apply_derived("derived.other", {}, {})
    with pytest.raises(ValueError, match="index is empty"):
        tmake_index("ivf", device="cpu").query(DATA[0], 3)


def test_probe_plan_and_nlist_clamp():
    t = tmake_index("ivf", device="cpu", nlist=64, nprobe=8)
    t.bulk_insert([f"d{i}" for i in range(20)], DATA[:20])
    p = t.probe_plan()
    assert p["nlist"] == 20 and p["nprobe"] == 8      # nlist <= live rows
    assert p["probe_k"] == 8 * p["cap"]
    assert t.probe_plan(nprobe=100)["nprobe"] == 20


def test_make_index_from_config():
    from repro_torch.configs.mememo import smoke_config
    from repro_torch.core.index import make_index_from_config
    from repro_torch.core.interface import HNSW
    cfg = smoke_config()
    idx = make_index_from_config(cfg, device="cpu")
    assert isinstance(idx, HNSW) and idx.M == cfg.M
    idx_ivf = make_index_from_config(cfg, kind="ivf", nlist=4, device="cpu")
    assert isinstance(idx_ivf, tivf.IVFVectorIndex) and idx_ivf.nlist == 4
    assert idx_ivf.nprobe == cfg.nprobe


def test_sharded_ivf_raises_not_implemented():
    """Sharded IVF is ported now (the name is kept from when it raised):
    2 shards return the 1-shard index's keys on the same rows."""
    one, two = (tmake_index("ivf", device="cpu", nlist=4, n_shards=s)
                for s in (1, 2))
    for t in (one, two):
        t.bulk_insert([f"d{i}" for i in range(60)], DATA[:60])
    assert two.query_batch(DATA[:3], 5)[0] == one.query_batch(DATA[:3], 5)[0]
