"""Port parity for the serving slice (CPU): the hashing encoder, the
retrieval engine, the LM (weights carried across by ``convert.py``), the
continuous-batching engine with RAG, and the ``launch.serve`` driver,
each against ``repro`` on the same inputs.

Tolerances: the encoder and tokenizer are numpy in both packages, so they
must be bit-identical. LM logits agree to atol 1e-4 (fp32 matmuls summed
in another order); greedy tokens and retrieved keys must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import corpus as jcorpus
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro.serve.retrieval import RetrievalEngine as JRetrievalEngine
from repro.core import make_index as jmake_index
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.index import make_index as tmake_index
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline
from repro_torch.serve.retrieval import RetrievalEngine

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
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params)))
    model.requires_grad_(False)
    return jcfg, params, cfg, model


# ---------------------------------------------------------------------------
# corpus + retrieval engine
# ---------------------------------------------------------------------------
def test_hashing_encoder_and_tokenizer_bit_identical():
    texts = [t for _, t in jcorpus.BUILTIN_CORPUS] + ["", "a b a_b 42"]
    want = jcorpus.HashingEncoder(dim=64, seed=3).encode(texts)
    got = tcorpus.HashingEncoder(dim=64, seed=3).encode(texts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tcorpus.HashingEncoder().encode(QUERIES[0]),
        jcorpus.HashingEncoder().encode(QUERIES[0]))
    for t in texts:
        np.testing.assert_array_equal(tcorpus.encode_ids(t, 256, 40),
                                      jcorpus.encode_ids(t, 256, 40))
    assert tcorpus.BUILTIN_CORPUS == jcorpus.BUILTIN_CORPUS


def _engine_trace(eng, index, vecs):
    """Drive a RetrievalEngine through buckets, same-tick dedup, LRU hits
    and a delete; return keys + stats after each phase."""
    out = []
    reqs = [eng.submit(v, k=3) for v in vecs[:5]] + [eng.submit(vecs[0], k=3)]
    eng.step()
    out.append(([r.keys for r in reqs], [r.from_cache for r in reqs]))
    out.append(eng.stats.as_dict())
    again = eng.retrieve(vecs[:3], k=3)                    # LRU hits
    out.append(([r.keys for r in again], [r.from_cache for r in again]))
    victim = again[0].keys[0]
    index.delete(victim)                                   # epoch bump
    after = eng.retrieve(vecs[:3], k=3)
    out.append(([r.keys for r in after], [r.from_cache for r in after]))
    assert all(victim not in r.keys for r in after)
    out.append(eng.stats.as_dict())
    return out


def test_retrieval_engine_matches_reference():
    enc = jcorpus.HashingEncoder()
    docs = jcorpus.BUILTIN_CORPUS
    vecs = enc.encode([t for _, t in docs])
    kw = dict(dim=enc.dim, metric="cosine", M=16, ef_construction=100)

    def build(make):
        idx = make()
        idx.bulk_insert([k for k, _ in docs], vecs)
        return idx

    jidx = build(lambda: jmake_index("hnsw", **kw))
    tidx = build(lambda: tmake_index("hnsw", device="cpu", **kw))
    want = _engine_trace(JRetrievalEngine(jidx, max_batch=4), jidx, vecs)
    got = _engine_trace(RetrievalEngine(tidx, max_batch=4), tidx, vecs)
    assert got == want
    # the bucket ladder: 5 distinct rows at max_batch 4 -> 4 + 1 rows
    assert got[1]["searches"] == 2 and got[1]["padded_queries"] == 0
    assert got[1]["dedup_hits"] == 1


# ---------------------------------------------------------------------------
# LM: prefill / decode_step logits with weights carried across
# ---------------------------------------------------------------------------
def test_prefill_and_decode_logits_match_reference(lm):
    jcfg, params, cfg, model = lm
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(3, 12)).astype(np.int32)
    lens = np.array([12, 5, 9], np.int32)
    jl, jc = jtf.prefill(params, jcfg, jnp.asarray(toks), dtype=jnp.float32,
                         max_len=32, prompt_lens=jnp.asarray(lens))
    tl, tc = ttf.prefill(model, torch.as_tensor(toks), max_len=32,
                         prompt_lens=torch.as_tensor(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-4,
                               rtol=0)
    nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
    # the port's two attention impls run on copies of the same cache
    caches = {impl: ttf.KVCache(tc.k.clone(), tc.v.clone(),
                                tc.cur_len.clone())
              for impl in ("flash", "dense")}
    for _ in range(3):
        jl, jc = jtf.decode_step(params, jcfg, jnp.asarray(nxt), jc,
                                 dtype=jnp.float32)
        for impl in ("flash", "dense"):
            tl, caches[impl] = ttf.decode_step(model, torch.as_tensor(nxt),
                                               caches[impl], attn_impl=impl)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=0, err_msg=impl)
        np.testing.assert_array_equal(caches["flash"].cur_len.numpy(),
                                      np.asarray(jc.cur_len))
        nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]


def test_model_configs_resolve_and_dtypes_are_checked(lm):
    """Every reference architecture resolves in the port, the off-path
    models too, equal to the reference's ``CONFIG`` and ``smoke_config()``
    field for field; bf16 and fp16 weights and the LM configs (SWA, MoE,
    kv_quant) build; weights of any other dtype are refused."""
    import dataclasses
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    _, _, cfg, _ = lm
    for dtype in (torch.bfloat16, torch.float16):
        model = ttf.LM(cfg, device="cpu", dtype=dtype)
        assert model.dtype == dtype
        assert all(w.dtype == dtype for w in model.parameters())
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        ttf.LM(cfg, device="cpu", dtype=torch.float64)
    for arch in ("graphsage-reddit", "mind", "wide-deep", "bert4rec", "fm"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jget_smoke_config(arch))
    for ok in (dataclasses.replace(cfg, kv_quant=True),
               dataclasses.replace(cfg, sliding_window=8),
               dataclasses.replace(cfg, moe=MoEConfig(4, 2, 32))):
        ttf.LM(ok, device="cpu")


# ---------------------------------------------------------------------------
# ServeEngine with RAG
# ---------------------------------------------------------------------------
def test_rag_engine_matches_reference_greedy(lm):
    jcfg, params, cfg, model = lm
    jrag = JRAGPipeline(index_kind="hnsw")
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    jeng = JServeEngine(params, jcfg, pipeline=jrag, slots=2, max_len=96,
                        dtype=jnp.float32)
    trag = RAGPipeline(index_kind="hnsw", device="cpu")
    trag.add_documents(tcorpus.BUILTIN_CORPUS)
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
    assert teng.stats.admitted == len(QUERIES) > teng.slots


def test_temperature_sampler_schedule_independent(lm):
    _, _, cfg, model = lm
    prompts = [np.arange(4 + 3 * i) % cfg.vocab for i in range(4)]

    def run(slots, seed):
        eng = ServeEngine(model, cfg, slots=slots, max_len=64, device="cpu",
                          sampler="temperature", temperature=0.8, seed=seed)
        return eng.generate(prompts, max_new_tokens=6)

    assert run(1, seed=0) == run(3, seed=0)
    assert run(3, seed=0) != run(3, seed=1)


def test_launch_serve_main_runs_on_cpu():
    out = tserve.main(["--rag", "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--max-len", "96", "--slots", "2"])
    assert len(out["reqs"]) == 3 and all(r.done for r in out["reqs"])
    assert all(len(r.docs) == 3 for r in out["reqs"])
    assert out["tokens"] == 3 * 2       # the first token comes from prefill
    # --tenants serves an IndexPool of two private corpora on the CPU
    out = tserve.main(["--rag", "--device", "cpu", "--tenants", "2",
                       "--requests", "3", "--max-new", "2", "--max-len",
                       "96", "--slots", "2"])
    assert [r.tenant for r in out["reqs"]] == ["tenant0", "tenant1",
                                               "tenant0"]
    assert all(r.done and len(r.docs) == 3 for r in out["reqs"])
    assert out["rag"].index.tenants() == ["tenant0", "tenant1"]
