"""Port parity for the exact-search slice (CPU): ``distance_topk_ref`` and
``ops.flat_topk``, the row codecs, ``FlatVectorIndex``, ``HNSW.exact_query``
and the flat/int8 RAG serve path, each against ``repro`` on the same numpy
inputs.

Tolerances: distances atol 1e-5 (rtol 1e-5 for l2, whose expanded form
sums squares of magnitude ~D): the two frameworks sum fp32 products in
another order. Ids must be equal, exactly so on integer-valued inputs
(exact fp32 arithmetic, ties broken on the lower id in both). The codec
and the rerank are numpy in both packages, so they must be bit-identical;
greedy tokens and retrieved keys must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import codec as jcodec
from repro.core import make_index as jmake_index
from repro.data import corpus as jcorpus
from repro.data.synthetic import make_corpus
from repro.kernels import ref as jref
from repro.kernels.distance_topk import distance_topk_pallas
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import codec as tcodec
from repro_torch.core import dispatch
from repro_torch.core.flat import FlatVectorIndex
from repro_torch.core.index import make_index as tmake_index
from repro_torch.data import corpus as tcorpus
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline

CODECS = ["fp32", "bf16", "int8"]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _rows(codec, x):
    """fp32 rows -> ((jax rows, jax scales), (torch rows, torch scales)),
    each package encoding with its own codec."""
    jenc, jscl = jcodec.get_codec(codec).encode(x)
    tenc, tscl = tcodec.get_codec(codec).encode(x)
    to_t = lambda a: None if a is None else tcodec.device_rows(a, "cpu")
    to_j = lambda a: None if a is None else jnp.asarray(a)
    return (to_j(jenc), to_j(jscl)), (to_t(tenc), to_t(tscl))


def _tol(metric):
    return dict(rtol=1e-5, atol=0) if metric == "l2" else dict(rtol=0,
                                                               atol=1e-5)


# ---------------------------------------------------------------------------
# distance_topk: plain version and ops.flat_topk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_distance_topk_ref_matches_jax(metric, codec):
    """The prime shape of tests/test_kernels.py (N 997, B 7), random rows."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(997, 32)).astype(np.float32)
    if metric == "cosine":
        x = _unit(x)
    q = rng.normal(size=(7, 32)).astype(np.float32)
    (jdb, jscl), (tdb, tscl) = _rows(codec, x)
    jd, ji = jref.distance_topk_ref(jdb, jnp.asarray(q), 5, metric=metric,
                                    scales=jscl)
    td, ti = tref.distance_topk_ref(tdb, torch.from_numpy(q), 5,
                                    metric=metric, scales=tscl)
    assert ti.dtype == torch.int32 and ti.shape == (7, 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **_tol(metric))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_distance_topk_ref_exact_on_integer_ties(metric, codec):
    """Integer-valued rows in [-2, 2]: many equal distances, which both
    packages order by the lower id; int8 rows carry scales 1.0."""
    rng = np.random.default_rng(41)
    x = rng.integers(-2, 3, size=(300, 16)).astype(np.float32)
    q = rng.integers(-2, 3, size=(9, 16)).astype(np.float32)
    if codec == "int8":
        jdb, jscl = jnp.asarray(x.astype(np.int8)), jnp.ones(300)
        tdb, tscl = torch.from_numpy(x.astype(np.int8)), torch.ones(300)
    else:
        (jdb, jscl), (tdb, tscl) = _rows(codec, x)
    jd, ji = jref.distance_topk_ref(jdb, jnp.asarray(q), 40, metric=metric,
                                    scales=jscl)
    td, ti = tref.distance_topk_ref(tdb, torch.from_numpy(q), 40,
                                    metric=metric, scales=tscl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_distance_topk_ref_matches_pallas_interpret(metric):
    """The TPU kernel in interpret mode (partials + the lax.top_k merge of
    repro.kernels.ops.flat_topk) against the port's plain version."""
    rng = np.random.default_rng(42)
    x = _unit(rng.normal(size=(997, 32)))
    q = _unit(rng.normal(size=(7, 32)))
    pd, pi = distance_topk_pallas(jnp.asarray(x), jnp.asarray(q), 5,
                                  metric=metric, block_q=4, block_n=64,
                                  interpret=True)
    neg, j = jax.lax.top_k(-pd, 5)
    jd, ji = -neg, jnp.take_along_axis(pi, j, axis=1)
    td, ti = tref.distance_topk_ref(torch.from_numpy(x), torch.from_numpy(q),
                                    5, metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **_tol(metric))


def test_flat_topk_cpu_tensors_take_the_plain_version_uncounted():
    rng = np.random.default_rng(43)
    x, scl = tcodec.get_codec("int8").encode(
        rng.normal(size=(50, 8)).astype(np.float32))
    db, scales = torch.from_numpy(x), torch.from_numpy(scl)
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    dispatch.reset()
    got = tops.flat_topk(db, q, 4, metric="l2", scales=scales)
    want = tref.distance_topk_ref(db, q, 4, metric="l2", scales=scales)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)
    with pytest.raises(ValueError, match="mixed devices"):
        tops.flat_topk(db, q.to("meta"), 4)


@pytest.mark.parametrize("rows", ["random", "integer"])
@pytest.mark.parametrize("k", [257, 600, 700])
def test_topk_in_passes_equals_one_call(k, rows):
    """The k > 256 chaining of ops.flat_topk, driven through the plain
    version: ceil(k / 256) passes, each after the last (d, id) of the one
    before, equal one plain call of k, ids and distances exactly; on
    integer rows in [-2, 2] many distances tie across pass boundaries."""
    rng = np.random.default_rng(45)
    n, metric = 700, "l2"
    if rows == "random":
        x = _unit(rng.normal(size=(n, 16)))
        q = _unit(rng.normal(size=(5, 16)))
        metric = "cosine"
    else:
        x = rng.integers(-2, 3, size=(n, 16)).astype(np.float32)
        q = rng.integers(-2, 3, size=(5, 16)).astype(np.float32)
    db, qt = torch.from_numpy(x), torch.from_numpy(q)
    calls = []

    def run_pass(out_d, out_i, after):
        calls.append(after is None)
        d, i = tref.distance_topk_ref(db, qt, out_d.shape[1], metric=metric,
                                      after=after)
        out_d.copy_(d)
        out_i.copy_(i)

    got = tops.topk_in_passes(run_pass, 5, k, "cpu")
    want = tref.distance_topk_ref(db, qt, k, metric=metric)
    assert calls == [True] + [False] * (-(-k // tops.TOPK_PASS_K) - 1)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    if rows == "integer":
        d = want[0].numpy()
        assert (d[:, 255] == d[:, 256]).any()     # a tie across a boundary


def test_flat_int8_and_exact_query_above_256_match_reference():
    """k the card's lists could not hold before passes: an int8 flat
    index over-fetching k 100 x 4 and HNSW.exact_query at k 300, against
    the JAX package."""
    data = make_corpus(500, 16, seed=9)
    qs = make_corpus(4, 16, seed=10)
    out = []
    for make in (jmake_index, lambda *a, **k: tmake_index(*a, device="cpu",
                                                          **k)):
        flat = make("flat", dim=16, metric="cosine", dtype="int8")
        flat.bulk_insert([f"r{i}" for i in range(500)], data)
        fk, fd = flat.query_batch(qs, k=100)
        hnsw = make("hnsw", metric="cosine", M=8, ef_construction=40)
        hnsw.bulk_insert([f"h{i}" for i in range(400)], data[:400])
        hk, hd = hnsw.exact_query(qs, k=300)
        out.append((fk, np.asarray(fd), hk, np.asarray(hd)))
    (jfk, jfd, jhk, jhd), (tfk, tfd, thk, thd) = out
    assert tfk == jfk and thk == jhk
    assert len(thk[0]) == 300 and len(tfk[0]) == 100
    np.testing.assert_allclose(tfd, jfd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(thd, jhd, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# codec: numpy in both packages, bit-identical
# ---------------------------------------------------------------------------
def _codec_inputs():
    rng = np.random.default_rng(44)
    x = rng.normal(size=(64, 24)).astype(np.float32) * 3
    x[5] = 0.0                                          # all-zero row
    x[6, :6] = [127.0, -0.5, 0.5, 1.5, 2.5, -2.5]       # int8 half-way
    x[6, 6:] = 0.0                                      # (scale 1.0)
    x[7] = 1e-42                                        # subnormal row
    # bf16 half-way cases: the dropped 16 bits are exactly 0x8000
    x[8] = (np.arange(24, dtype=np.uint32) << 16 | 0x3F808000).view(
        np.float32)
    x[9] = -x[8]
    x[10, :6] = [np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38]
    x[10, 6:] = 0.0
    return x


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_codec_bit_identical(name):
    x = _codec_inputs()
    if name == "int8":
        x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    jc, tc = jcodec.get_codec(name), tcodec.get_codec(name)
    jenc, jscl = jc.encode(x)
    tenc, tscl = tc.encode(x)
    jstore, tstore = jc.to_storage(jenc), tc.to_storage(tenc)
    assert tstore.dtype == jstore.dtype
    np.testing.assert_array_equal(tstore, jstore)
    if jscl is not None:
        assert tscl.dtype == jscl.dtype == np.float32
        np.testing.assert_array_equal(tscl, jscl)
        assert jscl[5] == tscl[5] == 1.0                # all-zero row
    else:
        assert tscl is None
    jdec, tdec = jc.decode(jenc, jscl), tc.decode(tenc, tscl)
    assert tdec.dtype == np.float32
    np.testing.assert_array_equal(tdec.view(np.uint32), jdec.view(np.uint32))
    np.testing.assert_array_equal(
        tc.from_storage(jstore), jc.to_storage(jc.from_storage(jstore)))
    np.testing.assert_array_equal(tc.roundtrip(x).view(np.uint32),
                                  jc.roundtrip(x).view(np.uint32))


def test_codec_registry_and_helpers_match():
    assert tcodec.CODEC_NAMES == jcodec.CODEC_NAMES
    assert tcodec.INF == jcodec.INF
    for name in CODECS:
        jc, tc = jcodec.get_codec(name), tcodec.get_codec(name)
        assert tcodec.get_codec(name.upper()) is tc
        assert (tc.lossy, tc.uses_scales, tc.default_rerank) == (
            jc.lossy, jc.uses_scales, jc.default_rerank)
        assert tc.bytes_per_vector(384) == jc.bytes_per_vector(384)
        for rf in (None, 0, 1, 3):
            assert (tcodec.effective_rerank(tc, rf)
                    == jcodec.effective_rerank(jc, rf))
        for arrays in ({}, {"vectors": 1}, {"vectors_enc": 1},
                       {"s0__vectors_enc": 1}):
            try:
                jcodec.check_codec_arrays(jc, arrays, "flat")
                want = None
            except ValueError as e:
                want = str(e)
            try:
                tcodec.check_codec_arrays(tc, arrays, "flat")
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want
    with pytest.raises(ValueError, match="unknown storage dtype"):
        tcodec.get_codec("fp8")


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_rerank_exact_bit_identical(metric):
    rng = np.random.default_rng(45)
    vecs = _unit(rng.normal(size=(40, 12)))
    q = rng.normal(size=(5, 12)).astype(np.float32)
    ids = rng.integers(-1, 40, size=(5, 9))
    ids[2] = -1                                         # no candidates
    ids[3, :4] = 7                                      # repeats
    jd, ji = jcodec.rerank_exact(vecs, q, ids, 4, metric=metric)
    td, ti = tcodec.rerank_exact(vecs, q, ids, 4, metric=metric)
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))
    np.testing.assert_array_equal(ti, ji)


# ---------------------------------------------------------------------------
# FlatVectorIndex: the conformance sequence of tests/test_index.py
# ---------------------------------------------------------------------------
def _r(d):
    """Distances rounded to 1e-4 (fp32 sums in another order)."""
    return tuple(round(float(x), 4) for x in np.ravel(d))


def _flat_trace(make):
    data = make_corpus(150, 16, seed=0)
    idx = make()
    out = []

    def q(v, k, exact=False):
        keys, d = (idx.exact_query if exact else idx.query)(v, k=k)
        return (tuple(map(tuple, keys)) if np.ndim(d) == 2 else tuple(keys),
                _r(d))

    idx.bulk_insert([f"d{i}" for i in range(150)], data)
    out.append(("bulk", idx.size, idx.mutation_epoch, idx.storage_dtype))
    out.append(("q7", q(data[7], 5)))
    idx.insert("extra", data[7] + 0.001)
    out.append(("insert", idx.size, idx.mutation_epoch, "extra" in idx))
    out.append(("batch", q(data[:3], 4)))
    out.append(("exact", q(data[:3], 4, exact=True)))
    idx.delete("d7")
    out.append(("delete", idx.size, idx.mutation_epoch, "d7" in idx.keys()))
    out.append(("q7b", q(data[7], 5)))
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
    out.append(("shards", idx.shard_count, idx.shard_stats()))
    out.append(("all", q(data[0], idx.size + 3)))       # k > live: padding
    out.append(("config", idx.config_dict()))
    return out


@pytest.mark.parametrize("dtype", CODECS)
def test_flat_index_crud_conformance_matches_reference(dtype):
    kw = dict(dim=16, metric="cosine", M=8, ef_construction=60, dtype=dtype)
    want = _flat_trace(lambda: jmake_index("flat", **kw))
    got = _flat_trace(lambda: tmake_index("flat", device="cpu", **kw))
    assert got == want
    assert got[-2][1][0][-3:] == (None, None, None)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_flat_index_int8_rerank_matches_reference(metric):
    """Over-fetch k·rf through the scan, then the exact rerank, on an
    explicit rerank_factor and a corpus smaller than k·rf."""
    data = make_corpus(30, 8, seed=5)
    qs = make_corpus(4, 8, seed=6)
    out = []
    for make in (jmake_index, lambda *a, **k: tmake_index(*a, device="cpu",
                                                          **k)):
        idx = make("flat", dim=8, metric=metric, dtype="int8",
                   rerank_factor=3)
        idx.bulk_insert([f"r{i}" for i in range(30)], data)
        keys, d = idx.query_batch(qs, k=12)
        out.append((keys, np.asarray(d)))
    assert out[1][0] == out[0][0]
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)


def test_flat_unported_surface_raises_not_implemented(tmp_path):
    """Several shards are ported now (the name is kept from when they
    raised): a fresh 2-shard index and a 1-shard store restored at 2
    shards answer as the 1-shard index."""
    two = tmake_index("flat", device="cpu", n_shards=2)
    sd = str(tmp_path / "s")
    idx = tmake_index("flat", device="cpu", store=sd)
    for t in (two, idx):
        t.insert("a", np.ones(4, np.float32))
        t.insert("b", -np.ones(4, np.float32))
    back = tmake_index("flat", device="cpu", store=sd, n_shards=2)
    assert back.shard_count == two.shard_count == 2
    q = np.ones((1, 4), np.float32)
    assert back.query_batch(q, 3)[0] == two.query_batch(q, 3)[0] == \
        idx.query_batch(q, 3)[0] == [["a", "b", None]]


# ---------------------------------------------------------------------------
# HNSW.exact_query
# ---------------------------------------------------------------------------
def test_hnsw_exact_query_matches_reference():
    data = make_corpus(200, 16, seed=7)
    qs = make_corpus(6, 16, seed=8)
    out = []
    for make in (jmake_index, lambda *a, **k: tmake_index(*a, device="cpu",
                                                          **k)):
        idx = make("hnsw", metric="cosine", M=8, ef_construction=40)
        idx.bulk_insert([f"h{i}" for i in range(200)], data)
        for key in ("h3", "h50", "h199"):
            idx.delete(key)
        idx.update("h10", qs[0])
        keys, d = idx.exact_query(qs, k=7)
        one_keys, one_d = idx.exact_query(qs[1], k=300)  # min(k, live)
        out.append((keys, np.asarray(d), one_keys, np.asarray(one_d)))
    (jk, jd, jok, jod), (tk, td, tok, tod) = out
    assert tk == jk and tok == jok and len(tok) == 197
    assert tk[0][0] == "h10"
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tod, jod, rtol=0, atol=1e-5)
    assert not {"h3", "h50", "h199"} & set(tok)


# ---------------------------------------------------------------------------
# the flat/int8 RAG serve path
# ---------------------------------------------------------------------------
QUERIES = ["how does hnsw search work",
           "why is on device retrieval private",
           "what does the document store hold",
           "how are vectors compared"]


@pytest.fixture(scope="module")
def lm():
    """(reference cfg, reference params, port cfg, port model) with the
    same weights."""
    jcfg = jget_smoke_config("llama3-8b")
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("llama3-8b")
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params)))
    model.requires_grad_(False)
    return jcfg, params, cfg, model


def test_rag_flat_int8_matches_reference_greedy(lm):
    jcfg, params, cfg, model = lm
    jrag = JRAGPipeline(index_kind="flat", index_dtype="int8")
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    jeng = JServeEngine(params, jcfg, pipeline=jrag, slots=2, max_len=96,
                        dtype=jnp.float32)
    trag = RAGPipeline(index_kind="flat", index_dtype="int8", device="cpu")
    trag.add_documents(tcorpus.BUILTIN_CORPUS)
    assert trag.index.storage_dtype == "int8"
    teng = ServeEngine(model, cfg, pipeline=trag, slots=2, max_len=96,
                       device="cpu")
    out = []
    for eng in (jeng, teng):
        reqs = [eng.submit_rag(q, k=2, max_new_tokens=5) for q in QUERIES]
        eng.run_until_drained()
        assert all(r.done for r in reqs)
        out.append([([d.key for d in r.docs], r.out_tokens, r.prompt)
                    for r in reqs])
    assert out[1] == out[0]


def test_launch_serve_flat_int8_runs_on_cpu():
    dispatch.reset()
    out = tserve.main(["--rag", "--index", "flat", "--index-dtype", "int8",
                       "--device", "cpu", "--requests", "3", "--max-new",
                       "3", "--max-len", "96", "--slots", "2"])
    assert len(out["reqs"]) == 3 and all(r.done for r in out["reqs"])
    assert all(len(r.docs) == 3 for r in out["reqs"])
    assert out["rag"].index.kind == "flat"
    assert out["rag"].index.storage_dtype == "int8"
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)
    # --tenants serves an int8 IndexPool on the CPU, through the plain
    # version of the slab scan
    out = tserve.main(["--rag", "--index-dtype", "int8", "--device", "cpu",
                       "--requests", "1", "--max-new", "2", "--max-len",
                       "96", "--tenants", "2"])
    assert out["rag"].index.storage_dtype == "int8"
    assert out["reqs"][0].done and len(out["reqs"][0].docs) == 3
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)
    # --shards is ported: the flat int8 index over 2 shards
    out = tserve.main(["--rag", "--index", "flat", "--index-dtype", "int8",
                       "--device", "cpu", "--requests", "1", "--max-new",
                       "2", "--max-len", "96", "--shards", "2"])
    assert out["rag"].index.shard_count == 2 and out["reqs"][0].done
