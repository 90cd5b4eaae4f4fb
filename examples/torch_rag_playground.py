"""RAG Playground (paper §2.2) on the PyTorch port — end-to-end on-device
RAG:

  1. index a document corpus (hashed-ngram embedder + any backend),
  2. take user queries, retrieve top-k docs,
  3. fill the {{user}}/{{context}} prompt template,
  4. generate with a small LM (llama3-8b's smoke config, random weights
     from seed 0) served through the continuous-batching engine.

    PYTHONPATH=src python examples/torch_rag_playground.py \\
        [--interactive] [--index {flat,ivf,hnsw,tiered}] [--device cpu]

The retriever is any ``VectorIndex`` backend; documents can also be
retracted live (``del <key>`` in interactive mode) — the tombstone is
honored by every later retrieval. On the card every decode tick runs the
``flash_decode`` kernel, and retrieval the index's kernels (``hnsw``:
``greedy_descent`` and ``beam_search``; ``flat``: ``distance_topk``;
``ivf``: the ``gather_distance`` hop kernel). ``main`` returns what it
prints as a dict.
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.corpus import BUILTIN_CORPUS
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline, lm_generate_fn
from repro_torch.utils import resolve_device

QUERIES = [
    "how does mememo use IndexedDB for vector storage?",
    "what controls recall at query time in HNSW?",
    "why does on device retrieval protect privacy?",
]
INDEXES = ("flat", "ivf", "hnsw", "tiered")


def main(interactive: bool = False, index: str = "hnsw",
         device: str = "cuda", model: tf.LM | None = None) -> dict:
    """``model``: the LM to serve (default: ``init_lm`` of the smoke config
    at seed 0 on ``device``)."""
    device = resolve_device(device)
    cfg = get_smoke_config("llama3-8b")
    if model is None:
        model = tf.init_lm(cfg, seed=0, device=device)
    engine = ServeEngine(model, cfg, slots=2, max_len=128,
                         dtype=torch.float32, device=device)

    rag = RAGPipeline(index_kind=index, device=device,
                      generate_fn=lm_generate_fn(engine, cfg.vocab, 96))
    rag.add_documents(BUILTIN_CORPUS)
    print(f"indexed {rag.index.size} documents "
          f"(backend={index}, {type(rag.index).__name__})\n")
    out = {"device": str(device), "index": index, "indexed": rag.index.size,
           "backend": type(rag.index).__name__, "answers": [],
           "interactive": []}

    def ask(q: str) -> dict:
        res = rag.answer(q, k=3)
        print(f"Q: {q}")
        for d in res["docs"]:
            print(f"   [{d.key}] d={d.distance:.3f}  {d.text[:70]}...")
        print(f"   prompt: {len(res['prompt'])} chars; "
              f"LM (untrained demo) -> {res['response'][:60]}\n")
        return {"query": q, "keys": [d.key for d in res["docs"]],
                "distances": [float(d.distance) for d in res["docs"]],
                "texts": [d.text for d in res["docs"]],
                "prompt": res["prompt"], "response": res["response"]}

    for q in QUERIES:
        out["answers"].append(ask(q))
    out["answers"].append(ask(QUERIES[0]))   # repeat: served from the LRU cache
    s = rag.retriever.stats.as_dict()
    print(f"retrieval: {s['searches']} device dispatches for "
          f"{s['requests']} queries, cache hit rate {s['hit_rate']:.2f} "
          f"(DESIGN.md §6)\n")
    out["stats"] = s

    if interactive:
        while True:
            q = input("query> ").strip()
            if not q:
                break
            if q.startswith("del "):             # retract a document live
                key = q[4:].strip()
                try:
                    rag.delete_document(key)
                    print(f"   deleted {key!r} "
                          f"({rag.index.size} docs remain)\n")
                    out["interactive"].append({"deleted": key,
                                               "remain": rag.index.size})
                except KeyError:
                    print(f"   no such key {key!r}\n")
                    out["interactive"].append({"missing": key})
                continue
            out["interactive"].append(ask(q))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--index", default="hnsw", choices=INDEXES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    main(**vars(ap.parse_args()))
