"""The port's examples (``examples/torch_*.py``) on the CPU against the
reference's (``examples/*.py``), each loaded from its file.

The reference's ``main`` prints and returns nothing, so its values are
read where it gets them: the names it imports are replaced, in its own
module, by subclasses and wrappers that record what each call returned
(``HNSW.query``, ``make_index(...).query``, ``simulate_search_traffic``,
``RAGPipeline.answer``). The port's ``main`` returns what it prints.

Tolerances: keys, prompts, greedy responses (from the reference's weights,
``convert.lm_params_from_jax``), retrieval stats and slow-tier
transaction counts equal; distances within 1e-5. The distributed
example's ids equal ``repro``'s ``distance_topk_ref`` on the same rows,
its distances within 1e-5. The IVF backends start the port's k-means from
the reference's draw (``init_rows`` patched), as ``test_torch_rag.py``
does.
"""
import builtins
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke_config
from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import ivf as tivf
from repro_torch.models import transformer as ttf

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
INTERACTIVE = ["del mememo-0", "how does mememo use IndexedDB for vector "
               "storage?", "del no-such-doc", ""]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def reference_draw(monkeypatch):
    monkeypatch.setattr(tivf, "init_rows", lambda n, k, seed: np.asarray(
        jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)))


def _same_hits(got: dict, want, what: str):
    keys, dists = want
    assert got["keys"] == list(keys), what
    np.testing.assert_allclose(got["distances"], np.asarray(dists),
                               atol=1e-5, err_msg=what)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_quickstart_matches_reference(monkeypatch):
    ref, port = _load("quickstart"), _load("torch_quickstart")
    rec = {"query": [], "exact": [], "backends": {}, "traffic": []}

    class SpyHNSW(ref.HNSW):
        def query(self, *a, **kw):
            rec["query"].append(super().query(*a, **kw))
            return rec["query"][-1]

        def exact_query(self, *a, **kw):
            rec["exact"].append(super().exact_query(*a, **kw))
            return rec["exact"][-1]

    def spy_make_index(kind, **kw):
        idx = make_index(kind, **kw)
        query = idx.query

        def spy_query(*a, **k):
            rec["backends"][kind] = query(*a, **k)
            return rec["backends"][kind]
        idx.query = spy_query
        return idx

    def spy_traffic(*a, **kw):
        rec["traffic"].append(simulate(*a, **kw))
        return rec["traffic"][-1]

    make_index, simulate = ref.make_index, ref.simulate_search_traffic
    monkeypatch.setattr(ref, "HNSW", SpyHNSW)
    monkeypatch.setattr(ref, "make_index", spy_make_index)
    monkeypatch.setattr(ref, "simulate_search_traffic", spy_traffic)
    ref.main()
    out = port.main(device="cpu")

    assert out["device"] == "cpu"
    _same_hits(out["query"], rec["query"][0], "first query")
    _same_hits(out["after_delete"], rec["query"][1], "after delete/update")
    _same_hits(out["exact"], rec["exact"][0], "exact_query")
    assert out["roundtrip_keys"] == rec["query"][1][0]
    assert out["export_mb"] > 0
    assert sorted(out["backends"]) == sorted(rec["backends"])
    for kind, hits in out["backends"].items():
        _same_hits(hits, rec["backends"][kind], kind)
    with_pref, without = rec["traffic"]
    assert out["transactions_with"] == with_pref.transactions
    assert out["transactions_without"] == without.transactions
    assert out["prefetch_p"] == ref.auto_prefetch_p(64)


# ---------------------------------------------------------------------------
# RAG Playground
# ---------------------------------------------------------------------------
def _echo_generate_fn(engine, vocab, max_len):
    return lambda prompt: f"{len(prompt)}:{prompt[-12:]}"


@pytest.mark.parametrize("index", ["hnsw", "flat", "ivf", "tiered"])
def test_rag_playground_matches_reference(monkeypatch, index):
    """hnsw: the reference's weights in the port's LM, greedy responses
    equal. The other backends check retrieval and prompts with a cheap
    echo generator patched into both examples (the served LM at the
    playground's max_len 128 prefills 127 positions in blocks of 1 on the
    CPU); flat also drives ``--interactive`` with a live delete."""
    ref, port = _load("rag_playground"), _load("torch_rag_playground")
    runs = []

    class SpyRAG(ref.RAGPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.answers, self.printed_stats = [], []
            stats = self.retriever.stats
            as_dict = stats.as_dict
            # the stats main prints, before any interactive query
            stats.as_dict = lambda: self.printed_stats.append(as_dict()) \
                or self.printed_stats[-1]
            runs.append(self)

        def answer(self, *a, **kw):
            self.answers.append(super().answer(*a, **kw))
            return self.answers[-1]

    monkeypatch.setattr(ref, "RAGPipeline", SpyRAG)
    model = None
    if index == "hnsw":
        cfg = get_smoke_config("llama3-8b")
        model = ttf.LM(cfg, device="cpu")
        model.load_state_dict(lm_params_from_jax(jax.tree.map(
            np.asarray, jtf.init_lm(jax.random.PRNGKey(0),
                                    jget_smoke_config("llama3-8b")))))
        model.requires_grad_(False)
    else:
        for mod in (ref, port):
            monkeypatch.setattr(mod, "lm_generate_fn", _echo_generate_fn)
    interactive = index == "flat"
    outs = []
    for run in (lambda: ref.main(interactive=interactive, index=index),
                lambda: outs.append(port.main(interactive=interactive,
                                              index=index, device="cpu",
                                              model=model))):
        lines = iter(INTERACTIVE)
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
        run()
    (rag,), (out,) = runs, outs

    assert (out["index"], out["indexed"]) == (index, 12)
    asked = out["answers"] + [a for a in out["interactive"] if "query" in a]
    assert len(asked) == len(rag.answers) == (5 if interactive else 4)
    for got, want in zip(asked, rag.answers):
        assert got["keys"] == [d.key for d in want["docs"]], got["query"]
        assert got["texts"] == [d.text for d in want["docs"]]
        np.testing.assert_allclose(got["distances"],
                                   [d.distance for d in want["docs"]],
                                   atol=1e-5)
        for f in ("query", "prompt", "response"):
            assert got[f] == want[f], (f, got["query"])
    assert [out["stats"]] == rag.printed_stats
    assert out["stats"]["hit_rate"] == 0.25
    if interactive:
        assert out["interactive"][0] == {"deleted": "mememo-0", "remain": 11}
        assert out["interactive"][2] == {"missing": "no-such-doc"}
        assert "mememo-0" not in out["interactive"][1]["keys"]
        assert rag.index.size == 11
    if model is not None:
        assert out["answers"][0]["response"].startswith("<")


# ---------------------------------------------------------------------------
# distributed retrieval and fault-tolerant training
# ---------------------------------------------------------------------------
def test_distributed_retrieval_matches_reference_topk():
    port = _load("torch_distributed_retrieval")
    out = port.main(device="cpu")
    db, q = port.corpus("cpu")
    d_ref, i_ref = jref.distance_topk_ref(jnp.asarray(db.numpy()),
                                          jnp.asarray(q.numpy()), port.K)
    assert out["devices"] == ["cpu"] * 8
    assert out["mesh"] == {"pod": 2, "data": 2, "model": 2}
    np.testing.assert_array_equal(out["ids"], np.asarray(i_ref))
    np.testing.assert_allclose(out["dists"], np.asarray(d_ref), atol=1e-5)
    assert out["match"] == 1.0
    assert out["collective_bytes"] == 0 and out["collectives"] == {}
    assert out["kernels"] == {"flat_topk": 8}


def test_fault_tolerant_training_recovers_exactly():
    out = _load("torch_fault_tolerant_training").main(device="cpu")
    assert out["restarts"] == 2
    assert out["diff"] < 2e-3
    assert out["recovered_losses"] == out["reference_losses"]
    assert all(np.isfinite(out["recovered_losses"]))
