"""Port parity for HNSW over encoded rows (CPU): the codec variants of
``gather_distance_ref`` and ``beam_search_ref``, the lossy ``HNSW`` index
(quantize at ingest, encoded device rows, over-fetch + fp32 rerank) and
the ``--rag --index hnsw --index-dtype int8`` serve path, each against
``repro`` on the same numpy inputs.

Tolerances: fp32 distances rtol 1e-6 / atol 1e-6 (the two frameworks sum
the decoded products in another order). Ids must be equal: exactly so on
integer-valued l2 rows, whose arithmetic is exact. The codec and the
builder are numpy in both packages, so encoded rows, scales, graphs and
byte counts must be bit-identical; keys and greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import codec as jcodec
from repro.core import dispatch as jdispatch
from repro.core import make_index as jmake_index
from repro.data import corpus as jcorpus
from repro.data.synthetic import make_corpus
from repro.kernels import ref as jref
from repro.kernels.beam_search import beam_search_pallas
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import codec as tcodec
from repro_torch.core import dispatch
from repro_torch.core import hnsw as thnsw
from repro_torch.core.index import make_index as tmake_index
from repro_torch.data import corpus as tcorpus
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline

LOSSY = ["bf16", "int8"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(codec, x):
    """fp32 rows -> ((jax rows, jax scales), (torch rows, torch scales)),
    each package encoding with its own codec."""
    jenc, jscl = jcodec.get_codec(codec).encode(x)
    tenc, tscl = tcodec.get_codec(codec).encode(x)
    to_t = lambda a: None if a is None else tcodec.device_rows(a, "cpu")
    to_j = lambda a: None if a is None else jnp.asarray(a)
    return (to_j(jenc), to_j(jscl)), (to_t(tenc), to_t(tscl))


def _graph(seed, n, d, m2, b, integer):
    rng = np.random.default_rng(seed)
    if integer:
        vec = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    else:
        vec, q = _unit(rng.normal(size=(n, d))), _unit(rng.normal(size=(b, d)))
    nbrs = rng.integers(0, n, size=(n, m2)).astype(np.int32)
    nbrs[rng.random((n, m2)) < 0.15] = -1                   # -1 padding
    nbrs[rng.integers(0, n, size=5)] = -1                    # whole -1 rows
    ep = rng.integers(0, n, size=b).astype(np.int32)
    return vec, nbrs, q, ep


# ---------------------------------------------------------------------------
# plain versions over encoded rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_gather_distance_ref_codecs_match_jax(codec, metric):
    rng = np.random.default_rng(40)
    x = _unit(rng.normal(size=(300, 24)))
    (jv, js), (tv, ts) = _rows(codec, x)
    q = _unit(rng.normal(size=(7, 24)))
    ids = rng.integers(0, 300, size=(7, 11)).astype(np.int32)
    want = jref.gather_distance_ref(jv, jnp.asarray(q), jnp.asarray(ids),
                                    metric=metric, scales=js)
    got = tref.gather_distance_ref(tv, _t(q), _t(ids), metric=metric,
                                   scales=ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # ops on CPU tensors is the plain version, uncounted
    dispatch.reset()
    torch.testing.assert_close(
        tops.gather_distance(tv, _t(q), _t(ids), metric=metric, scales=ts),
        got, rtol=0, atol=0)
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)


def _beam_pair(codec, vec, nbrs, q, ep, metric, **kw):
    """beam_search_ref of both packages on the codec's rows of ``vec``.
    Integer-valued int8 rows go in raw with scales 1.0."""
    if codec == "int8" and np.array_equal(vec, np.round(vec)):
        jv, js = jnp.asarray(vec.astype(np.int8)), jnp.ones(len(vec))
        tv, ts = _t(vec.astype(np.int8)), torch.ones(len(vec))
    else:
        (jv, js), (tv, ts) = _rows(codec, vec)
    ep_d = np.asarray(jref.gather_distance_ref(
        jv, jnp.asarray(q), jnp.asarray(ep[:, None]), metric=metric,
        scales=js))[:, 0]
    want = jref.beam_search_ref(jv, jnp.asarray(nbrs), jnp.asarray(q),
                                jnp.asarray(ep), jnp.asarray(ep_d),
                                metric=metric, scales=js, **kw)
    got = tref.beam_search_ref(tv, _t(nbrs), _t(q), _t(ep), _t(ep_d),
                               metric=metric, scales=ts, **kw)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("expand_t", [1, 4])
def test_beam_search_ref_codecs_exact_on_integer_rows(codec, metric,
                                                      expand_t):
    vec, nbrs, q, ep = _graph(41, 300, 16, 8, 6, integer=True)
    (ji, jd), (ti, td) = _beam_pair(codec, vec, nbrs, q, ep, metric,
                                    ef=16, expand_t=expand_t)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("expand_t", [1, 4])
def test_beam_search_ref_codecs_match_jax_on_cosine_rows(codec, expand_t):
    vec, nbrs, q, ep = _graph(42, 400, 24, 12, 8, integer=False)
    (ji, jd), (ti, td) = _beam_pair(codec, vec, nbrs, q, ep, "cosine",
                                    ef=24, expand_t=expand_t)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, **TOL)


@pytest.mark.parametrize("codec", LOSSY)
def test_beam_search_ref_codecs_match_pallas_interpret(codec):
    """The TPU kernel itself (interpret mode, as tests/test_beam_search.py
    runs it) against the port's plain version on encoded rows."""
    vec, nbrs, q, ep = _graph(43, 256, 16, 10, 8, integer=False)
    (jv, js), (tv, ts) = _rows(codec, vec)
    ep_d = np.asarray(jref.gather_distance_ref(
        jv, jnp.asarray(q), jnp.asarray(ep[:, None]), scales=js))[:, 0]
    kw = dict(ef=16, metric="cosine", expand_t=4)
    ki, kd = beam_search_pallas(jv, jnp.asarray(nbrs), jnp.asarray(q),
                                jnp.asarray(ep), jnp.asarray(ep_d),
                                scales=js, interpret=True, **kw)
    ti, td = tref.beam_search_ref(tv, _t(nbrs), _t(q), _t(ep), _t(ep_d),
                                  scales=ts, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_allclose(td.numpy(), np.asarray(kd), **TOL)


# ---------------------------------------------------------------------------
# the lossy HNSW index (sequential builder)
# ---------------------------------------------------------------------------
def _lossy_trace(idx, jd):
    """A CRUD + query sequence on a lossy HNSW -> what every step saw;
    ``jd`` is the package's dispatch module (h2d bytes per query)."""
    data = make_corpus(150, 16, seed=20)
    q = make_corpus(5, 16, seed=21)
    extra = make_corpus(4, 16, seed=22)
    out = []
    idx.bulk_insert([f"d{i}" for i in range(150)], data)
    for step in ("first", "insert", "delete", "update"):
        if step == "insert":
            idx.insert("x0", extra[0])
            idx.insert("x1", extra[1])
        elif step == "delete":
            idx.delete("d7")
            idx.delete("x0")
        elif step == "update":
            idx.update("d5", extra[2])
        jd.reset("hnsw.h2d_bytes")
        keys, d = idx.query_batch(q, k=6)
        out.append((step, keys, np.asarray(d), jd.get("hnsw.h2d_bytes"),
                    idx.size, idx.mutation_epoch))
    return out


@pytest.mark.parametrize("codec", LOSSY)
def test_lossy_hnsw_matches_reference(codec):
    """Keys equal, distances to 1e-6, encoded rows and scales identical,
    the same host -> device bytes at every sync (the full upload, then
    dirty rows only)."""
    kw = dict(metric="cosine", M=8, ef_construction=40, dtype=codec)
    j = jmake_index("hnsw", **kw)
    t = tmake_index("hnsw", device="cpu", **kw)
    want = _lossy_trace(j, jdispatch)
    got = _lossy_trace(t, dispatch)
    for (ws, wk, wd, wb, wn, we), (gs, gk, gd, gb, gn, ge) in zip(want, got):
        assert (gs, gk, gn, ge) == (ws, wk, wn, we)
        np.testing.assert_allclose(gd, wd, **TOL)
        assert gb == wb, (gs, gb, wb)
    jc, tc = jcodec.get_codec(codec), tcodec.get_codec(codec)
    np.testing.assert_array_equal(tc.to_storage(t._enc),
                                  jc.to_storage(j._enc))
    if codec == "int8":
        np.testing.assert_array_equal(t._scales, j._scales)
    else:
        assert t._scales is None and j._scales is None
    np.testing.assert_array_equal(t._builder.vectors, j._builder.vectors)
    assert t.storage_dtype == codec
    assert t.config_dict() == j.config_dict()
    assert t._device_graph.vectors.dtype == {"bf16": torch.bfloat16,
                                             "int8": torch.int8}[codec]


def test_lossy_hnsw_incremental_sync_equals_full_upload_int8():
    """Mutations after the first query go through the codec variant of the
    dirty-row copy; the resident graph must equal a from-scratch upload of
    the same host state, and queries must not change."""
    data = make_corpus(100, 16, seed=15)
    idx = tmake_index("hnsw", device="cpu", metric="cosine", M=8,
                      ef_construction=40, dtype="int8")
    idx.bulk_insert([f"d{i}" for i in range(100)], data)
    q = make_corpus(3, 16, seed=16)
    idx.query_batch(q, 5)                        # resident device graph
    idx.insert("new", make_corpus(1, 16, seed=17)[0])
    idx.delete("d3")
    k_inc, d_inc = idx.query_batch(q, 5)         # incremental copy
    dg = idx._device_graph
    idx._device_graph = None                     # force the full upload
    k_full, d_full = idx.query_batch(q, 5)
    assert k_inc == k_full
    np.testing.assert_array_equal(d_inc, d_full)
    full = idx._device_graph
    for name in ("vectors", "scales", "neighbors0", "upper", "levels",
                 "deleted"):
        assert torch.equal(getattr(dg, name), getattr(full, name)), name
    assert (dg.entry, dg.max_level) == (full.entry, full.max_level)


def test_lossy_hnsw_search_graph_decodes_the_entry_row():
    """search_graph on an int8 DeviceGraph equals the search of the same
    graph over the decoded fp32 rows (integer rows, scales 1.0: exact)."""
    from repro_torch.core import hnsw_build as tb
    rng = np.random.default_rng(44)
    vec = rng.integers(-4, 5, size=(300, 8)).astype(np.float32)
    q = rng.integers(-4, 5, size=(9, 8)).astype(np.float32)
    g = tb.build_sequential(vec, M=6, ef_construction=40, metric="l2",
                            seed=3)
    enc = vec.astype(np.int8)
    scl = np.full(300, 1.0, np.float32)
    dg8 = thnsw.to_device_graph(g, enc=enc, scales=scl, device="cpu")
    dg32 = thnsw.to_device_graph(g, device="cpu")
    assert dg8.vectors.dtype == torch.int8 and dg8.scales.shape == (300,)
    for impl in ("fused", "jnp"):
        a = thnsw.search_graph(dg8, q, k=8, ef=16, beam_impl=impl)
        b = thnsw.search_graph(dg32, q, k=8, ef=16, beam_impl=impl)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_lossy_hnsw_keeps_unported_surface_raising(tmp_path):
    """Under a lossy codec several shards are ported now (the name is kept
    from when they raised): a fresh 2-shard index, and a stored one
    restored at 2 shards with its encoded row carried over, not
    re-quantized."""
    assert tmake_index("hnsw", device="cpu", dtype="int8",
                       n_shards=2).shard_count == 2
    sd = str(tmp_path / "s")
    idx = tmake_index("hnsw", device="cpu", dtype="int8", store=sd)
    idx.insert("a", np.ones(4, np.float32))
    two = tmake_index("hnsw", device="cpu", dtype="int8", store=sd,
                      n_shards=2)
    child = two._shards[two._key2shard["a"]]
    assert child._enc.tobytes() == idx._enc.tobytes()
    assert child._scales.tobytes() == idx._scales.tobytes()


# ---------------------------------------------------------------------------
# the hnsw/int8 RAG serve path
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


def test_rag_hnsw_int8_matches_reference_greedy(lm):
    jcfg, params, cfg, model = lm
    jrag = JRAGPipeline(index_kind="hnsw", index_dtype="int8")
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    jeng = JServeEngine(params, jcfg, pipeline=jrag, slots=2, max_len=96,
                        dtype=jnp.float32)
    trag = RAGPipeline(index_kind="hnsw", index_dtype="int8", device="cpu")
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


def test_launch_serve_hnsw_int8_returns_reference_keys():
    """``launch.serve --rag --index hnsw --index-dtype int8 --device cpu``
    serves the keys the reference's int8 HNSW pipeline retrieves for the
    same queries, through the plain versions (no kernel counted)."""
    dispatch.reset()
    out = tserve.main(["--rag", "--index", "hnsw", "--index-dtype", "int8",
                       "--device", "cpu", "--requests", "3", "--max-new",
                       "3", "--max-len", "96", "--slots", "2"])
    reqs = out["reqs"]
    assert len(reqs) == 3 and all(r.done for r in reqs)
    assert out["rag"].index.kind == "hnsw"
    assert out["rag"].index.storage_dtype == "int8"
    assert all(dispatch.get(c) == 0 for c in dispatch.KERNEL_COUNTERS)
    jrag = JRAGPipeline(index_kind="hnsw", index_dtype="int8")
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    want = [[d.key for d in docs]
            for docs in jrag.retrieve_batch([r.query for r in reqs], k=3)]
    assert [[d.key for d in r.docs] for r in reqs] == want
