"""Port parity for the single-call RAG surface (CPU): ``RAGPipeline.answer``
with a ``generate_fn``, ``lm_generate_fn``, ``ServeEngine.generate_rag``,
``RagRequest.result`` and ``RetrievalEngine.retrieve_one``, over every
index kind, against ``repro``; then the served ``--index ivf|tiered``
runs of ``launch.serve`` on the CPU.

The IVF cases start the port's k-means from the reference's draw
(``init_rows`` patched), so both packages train the same centroids.

Tolerances: keys, prompts, responses and greedy tokens (from converted
params) must be equal; the retrieval cache must behave as
``tests/test_retrieval.py`` holds the reference's.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import corpus as jcorpus
from repro.data.synthetic import make_corpus
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro.serve.rag import lm_generate_fn as jlm_generate_fn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import ivf as tivf
from repro_torch.core.index import make_index as tmake_index
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import RagRequest, ServeEngine
from repro_torch.serve.rag import RAGPipeline, lm_generate_fn
from repro_torch.serve.retrieval import RetrievalEngine

KINDS = ["flat", "ivf", "hnsw", "tiered"]
QUESTION = "how does mememo prefetch from IndexedDB?"
QUERIES = ["how does hnsw search work",
           "why is on device retrieval private",
           "what does efConstruction control"]


@pytest.fixture(autouse=True)
def reference_draw(monkeypatch):
    monkeypatch.setattr(tivf, "init_rows", lambda n, k, seed: np.asarray(
        jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)))


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


def _echo(prompt: str) -> str:
    return f"{len(prompt)}:{prompt[-12:]}"


def _keys(docs):
    return [d.key for d in docs]


def _same_answer(a, b):
    assert _keys(b["docs"]) == _keys(a["docs"])
    assert [d.text for d in b["docs"]] == [d.text for d in a["docs"]]
    np.testing.assert_allclose([d.distance for d in b["docs"]],
                               [d.distance for d in a["docs"]], atol=1e-5)
    for f in ("query", "prompt", "response"):
        assert b[f] == a[f], f


# ---------------------------------------------------------------------------
# RAGPipeline.answer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_answer_with_generate_fn_matches_reference(kind):
    """tests/test_index.py's answer/delete/update flow through both
    packages: equal docs, prompts and responses at every step."""
    jrag = JRAGPipeline(index_kind=kind, generate_fn=_echo)
    trag = RAGPipeline(index_kind=kind, generate_fn=_echo, device="cpu")
    for rag in (jrag, trag):
        rag.add_documents(jcorpus.BUILTIN_CORPUS)
    out = [rag.answer(QUESTION, k=3) for rag in (jrag, trag)]
    _same_answer(*out)
    assert any(d.key.startswith("mememo") for d in out[1]["docs"])
    assert "{{user}}" not in out[1]["prompt"]
    top = out[1]["docs"][0].key
    for rag in (jrag, trag):
        rag.delete_document(top)
    out = [rag.answer(QUESTION, k=3) for rag in (jrag, trag)]
    _same_answer(*out)
    assert all(d.key != top for d in out[1]["docs"])
    for rag in (jrag, trag):
        rag.update_document("tpu-0",
                            "mememo prefetches neighbors from indexeddb")
    out = [rag.answer(QUESTION, k=2) for rag in (jrag, trag)]
    _same_answer(*out)
    assert any(d.key == "tpu-0" for d in out[1]["docs"])
    assert RAGPipeline(index_kind=kind, device="cpu").answer(
        QUESTION)["response"] is None          # no generate_fn: no response


# ---------------------------------------------------------------------------
# the LM behind the surface: lm_generate_fn and generate_rag
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ivf", "tiered"])
def test_lm_generate_fn_and_generate_rag_match_reference(lm, kind):
    """``answer`` through ``lm_generate_fn`` (a one-slot engine), then
    ``generate_rag`` on a two-slot engine: equal docs, prompts and greedy
    tokens from the same weights."""
    jcfg, params, cfg, model = lm
    jrag = JRAGPipeline(index_kind=kind, generate_fn=jlm_generate_fn(
        JServeEngine(params, jcfg, slots=1, max_len=96, dtype=jnp.float32),
        jcfg.vocab, 64))
    trag = RAGPipeline(index_kind=kind, device="cpu",
                       generate_fn=lm_generate_fn(
                           ServeEngine(model, cfg, slots=1, max_len=96,
                                       device="cpu"), cfg.vocab, 64))
    for rag in (jrag, trag):
        rag.add_documents(jcorpus.BUILTIN_CORPUS)
    want, got = (rag.answer(QUERIES[0], k=2) for rag in (jrag, trag))
    _same_answer(want, got)
    assert got["response"].startswith("<")
    jeng = JServeEngine(params, jcfg, slots=2, max_len=96, dtype=jnp.float32)
    teng = ServeEngine(model, cfg, slots=2, max_len=96, device="cpu")
    want = jeng.generate_rag(jrag, QUERIES, k=2, max_new_tokens=4)
    got = teng.generate_rag(trag, QUERIES, k=2, max_new_tokens=4)
    for a, b in zip(want, got):
        _same_answer(a, b)
        assert len(b["docs"]) == 2 and "{{context}}" not in b["prompt"]
    assert got[1]["docs"][0].key.startswith("priv")


def test_rag_request_result_and_generate_rag_guards(lm):
    _, _, cfg, model = lm
    r = RagRequest(query="q")
    assert r.result() == {"query": "q", "docs": [], "prompt": None,
                          "response": None}
    rag = RAGPipeline(index_kind="flat", device="cpu")
    rag.add_documents(tcorpus.BUILTIN_CORPUS)
    eng = ServeEngine(model, cfg, slots=2, max_len=96, device="cpu")
    # a tenant on a single index raises as the reference's pipeline does
    with pytest.raises(ValueError, match="tenant= requires an IndexPool"):
        eng.generate_rag(rag, QUERIES[:1], tenants=["a"])
    rows = eng.generate_rag(rag, QUERIES[:2], k=1, max_new_tokens=2)
    assert eng.pipeline is rag and not eng.poll()
    assert [sorted(row) for row in rows] == [
        ["docs", "prompt", "query", "response"]] * 2
    assert all(len(row["response"].split()) == 2 for row in rows)
    with pytest.raises(ValueError, match="different pipeline"):
        eng.generate_rag(RAGPipeline(index_kind="flat", device="cpu"),
                         QUERIES[:1])


# ---------------------------------------------------------------------------
# retrieve_one: the cache in front of every index kind
# ---------------------------------------------------------------------------
def _build(kind, n=60, dim=16):
    data = make_corpus(n, dim, seed=0)
    knobs = (dict(nlist=4, nprobe=4) if kind == "ivf"
             else dict(M=8, ef_construction=60, ef_search=48))
    idx = tmake_index(kind, device="cpu", dim=dim, metric="cosine", **knobs)
    idx.bulk_insert([f"d{i}" for i in range(n)], data)
    return idx, data


def _counting(idx):
    calls = {"n": 0}
    orig = idx.query_batch

    def wrapped(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    idx.query_batch = wrapped
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_retrieve_one_serves_repeats_from_cache(kind):
    idx, data = _build(kind)
    eng = RetrievalEngine(idx, max_batch=8)
    first = eng.retrieve_one(data[7], k=3)
    assert not first.from_cache and first.done and first.keys[0] == "d7"
    calls = _counting(idx)
    again = eng.retrieve_one(data[7], k=3)
    assert calls["n"] == 0 and again.from_cache
    assert again.keys == first.keys
    np.testing.assert_array_equal(again.dists, first.dists)
    assert not eng.retrieve_one(data[7], k=5).from_cache   # another k
    assert eng.stats.cache_hits == 1


@pytest.mark.parametrize("kind", KINDS)
def test_retrieve_one_epoch_invalidation(kind):
    """A retracted document is never served from a cached result."""
    idx, data = _build(kind)
    eng = RetrievalEngine(idx, max_batch=8)
    assert eng.retrieve_one(data[7], k=3).keys[0] == "d7"
    idx.delete("d7")
    after = eng.retrieve_one(data[7], k=3)
    assert not after.from_cache and "d7" not in after.keys
    assert eng.stats.invalidations == 1
    idx.insert("shadow", data[8])
    r = eng.retrieve_one(data[8], k=3)
    assert not r.from_cache and "shadow" in r.keys[:2]


def test_retrieve_one_lru_and_bypass():
    idx, data = _build("ivf")
    eng = RetrievalEngine(idx, max_batch=8, cache_size=2)
    for i in range(3):
        eng.retrieve_one(data[i], k=3)
    assert eng.stats.evictions == 1
    assert eng.retrieve_one(data[2], k=3).from_cache
    assert not eng.retrieve_one(data[0], k=3).from_cache
    off = RetrievalEngine(idx, max_batch=8, cache_size=0)
    calls = _counting(idx)
    for _ in range(2):
        assert not off.retrieve_one(data[0], k=3).from_cache
    assert calls["n"] == 2 and off.stats.cache_hits == 0
    # a tenant on a single index raises as the reference's engine does
    with pytest.raises(ValueError, match="is single-tenant"):
        eng.retrieve_one(data[0], k=3, tenant="a")


# ---------------------------------------------------------------------------
# launch.serve --rag --index ivf|tiered on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [["--index", "ivf", "--index-dtype", "int8"],
                                  ["--index", "ivf", "--index-dtype", "bf16"],
                                  ["--index", "tiered"]])
def test_launch_serve_ivf_and_tiered_run_on_cpu(argv, caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        out = tserve.main(["--rag", *argv, "--device", "cpu", "--requests",
                           "3", "--max-new", "3", "--max-len", "96",
                           "--slots", "2"])
    reqs = out["reqs"]
    assert len(reqs) == 3 and all(r.done for r in reqs)
    assert out["tokens"] == 3 * 2
    idx = out["rag"].index
    assert idx.kind == argv[1]
    if argv[1] == "ivf":
        assert idx.storage_dtype == argv[3]
        p = idx.probe_plan()
        assert f"ivf: nlist {p['nlist']}, list cap {p['cap']}" in caplog.text
    else:
        assert "tiered: {'transactions'" in caplog.text
    jrag = JRAGPipeline(index_kind=argv[1],
                        index_dtype=argv[3] if len(argv) > 2 else None)
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    want = [_keys(d) for d in jrag.retrieve_batch(
        [r.query for r in reqs], k=3)]
    assert [_keys(r.docs) for r in reqs] == want


def test_ivf_and_tiered_entry_points_refuse_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("ivf", "tiered"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmake_index(kind)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RAGPipeline(index_kind=kind)
