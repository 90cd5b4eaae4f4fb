"""RAG pipeline — the paper's end-to-end loop (C4, §2 RAG Playground),
ported from ``repro/serve/rag.py`` for a single index:

    encode(query) -> k-NN retrieve (a VectorIndex on the device) -> fill the
    {{user}}/{{context}} prompt template -> generate with the LM.

Everything stays in this process and on its device: no external retrieval
service — the privacy property the paper is about. The pipeline carries
the index's CRUD: documents can be added, re-embedded (update) and
retracted (delete) after indexing. Retrieval goes through a
``RetrievalEngine``, whose LRU cache every mutation invalidates.

``index_store=`` (an ``IndexStore`` or a directory) makes the index
durable: a warm store restores the previous session's index, its
``mutation_epoch`` included, instead of building a fresh one, and
``register_texts`` refills the text side-table without re-embedding.

``answer`` is the single-call surface (retrieve, fill, generate with a
``generate_fn``; ``lm_generate_fn`` adapts a ``ServeEngine``). The
multi-tenant pool mode waits for ROADMAP.md §1 ("tenancy") and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.index import VectorIndex, make_index
from repro_torch.data.corpus import DocumentStore, HashingEncoder, encode_ids
from repro_torch.serve.retrieval import RetrievalEngine, reject_tenant

DEFAULT_TEMPLATE = (
    "You are a helpful assistant. Use the context to answer.\n"
    "Context:\n{{context}}\n"
    "Question: {{user}}\n"
    "Answer:"
)


@dataclasses.dataclass
class RetrievedDoc:
    key: str
    text: str
    distance: float


@dataclasses.dataclass
class PendingRetrieval:
    """Handle returned by :meth:`RAGPipeline.submit_retrieval`. Wraps the
    ``RetrievalEngine`` request (``None`` when the corpus was empty at
    submission: resolved at once with no docs) and defers the key ->
    document-text lookup until the caller needs the docs."""
    request: object | None              # RetrievalRequest | None
    _pipeline: "RAGPipeline" = dataclasses.field(repr=False, default=None)

    @property
    def done(self) -> bool:
        return self.request is None or self.request.done

    def docs(self) -> list[RetrievedDoc]:
        """Materialize the retrieved documents (requires ``done``)."""
        if self.request is None:
            return []
        if not self.request.done:
            raise RuntimeError("retrieval still in flight: poll first")
        if self.request.error is not None:
            raise self.request.error
        return self._pipeline._materialize(self.request.keys,
                                           self.request.dists)


class RAGPipeline:
    def __init__(self, *, encoder: HashingEncoder | None = None,
                 index: VectorIndex | None = None,
                 index_kind: str = "hnsw",
                 store: DocumentStore | None = None,
                 index_store=None,
                 template: str = DEFAULT_TEMPLATE,
                 generate_fn: Callable[[str], str] | None = None,
                 M: int = 16, ef_construction: int = 100,
                 retrieval_batch: int = 128, retrieval_cache: int = 1024,
                 index_shards: int | None = None,
                 index_dtype: str | None = None,
                 index_beam_impl: str | None = None,
                 device=None):
        # index_shards / index_dtype / index_beam_impl: None keeps the
        # backend default (on a warm restore, the stored value); the index
        # rejects what is not ported yet
        self.encoder = encoder or HashingEncoder()
        cfg = {}
        if index_shards is not None:
            cfg["n_shards"] = index_shards
        if index_dtype is not None:
            cfg["dtype"] = index_dtype
        if index_beam_impl is not None:
            cfg["beam_impl"] = index_beam_impl
        self.index = index if index is not None else make_index(
            index_kind, store=index_store, metric="cosine",
            dim=self.encoder.dim, M=M, ef_construction=ef_construction,
            device=device, **cfg)
        self.store = store or DocumentStore()
        self.template = template
        self.generate_fn = generate_fn
        self.retriever = RetrievalEngine(self.index,
                                         max_batch=retrieval_batch,
                                         cache_size=retrieval_cache)

    # --------------------------------------------------------------- data
    def add_documents(self, docs: list[tuple[str, str]],
                      tenant: str | None = None):
        """docs: [(key, text)] — embed + index + store (bulk write, C3)."""
        reject_tenant(tenant)
        keys = [k for k, _ in docs]
        vecs = self.encoder.encode([t for _, t in docs])
        self.index.bulk_insert(keys, vecs)
        for k, t in docs:
            self.store.add(k, t)

    def register_texts(self, docs: list[tuple[str, str]],
                       tenant: str | None = None):
        """Warm-restart companion to ``add_documents``: (re)populate the
        text store WITHOUT touching the index. A warm-restored index
        already holds the embeddings; re-inserting them would cost WAL
        records and epoch bumps for nothing. Only documents the index
        knows are registered."""
        reject_tenant(tenant)
        for k, t in docs:
            if k in self.index:
                self.store.add(k, t)

    def add_document(self, key: str, text: str, tenant: str | None = None):
        reject_tenant(tenant)
        self.index.insert(key, self.encoder.encode(text)[0])
        self.store.add(key, text)

    def update_document(self, key: str, text: str,
                        tenant: str | None = None):
        """Re-embed + replace an indexed document in place."""
        reject_tenant(tenant)
        self.index.update(key, self.encoder.encode(text)[0])
        self.store.add(key, text)

    def delete_document(self, key: str, tenant: str | None = None):
        """Retract a document: tombstoned in the index, purged from the
        store — it can never be retrieved into a prompt again."""
        reject_tenant(tenant)
        self.index.delete(key)
        self.store.remove(key)

    # ------------------------------------------------------------ retrieve
    def current_epoch(self, tenant: str | None = None) -> int:
        """Mutation epoch governing retrieval validity: a prompt is only
        built from results whose epoch is still current."""
        reject_tenant(tenant)
        return self.index.mutation_epoch

    def _materialize(self, keys, dists) -> list[RetrievedDoc]:
        return [RetrievedDoc(key, self.store.get(key).text, float(d))
                for key, d in zip(keys, dists) if key is not None]

    def submit_retrieval(self, query: str, k: int = 3,
                         tenant: str | None = None) -> PendingRetrieval:
        """Async retrieval entry point: encode the query and enqueue it on
        the RetrievalEngine without searching. An empty corpus resolves at
        once with no docs."""
        reject_tenant(tenant)
        size = self.index.size
        if size == 0:
            return PendingRetrieval(None, self)
        qv = self.encoder.encode([query])[0]
        req = self.retriever.submit(qv, k=min(k, size))
        return PendingRetrieval(req, self)

    def poll_retrieval(self) -> int:
        """Run at most one RetrievalEngine coalescing tick."""
        return self.retriever.poll()

    def retrieve(self, query: str, k: int = 3,
                 tenant: str | None = None) -> list[RetrievedDoc]:
        reject_tenant(tenant)
        return self.retrieve_batch([query], k)[0]

    def retrieve_batch(self, queries: list[str], k: int = 3,
                       tenants: list[str] | None = None
                       ) -> list[list[RetrievedDoc]]:
        """Retrieve for many queries in ONE RetrievalEngine tick."""
        reject_tenant(tenants)
        pend = [self.submit_retrieval(q, k) for q in queries]
        self.retriever.run_until_drained()
        return [p.docs() for p in pend]

    # ------------------------------------------------------------- prompt
    def build_prompt(self, query: str, docs: list[RetrievedDoc]) -> str:
        ctx = "\n".join(f"[{i+1}] {d.text}" for i, d in enumerate(docs))
        return (self.template
                .replace("{{context}}", ctx)
                .replace("{{user}}", query))

    # ------------------------------------------------------------ generate
    def answer(self, query: str, k: int = 3,
               tenant: str | None = None) -> dict:
        """The single-call RAG surface: retrieve, fill the template and,
        with a ``generate_fn``, generate."""
        docs = self.retrieve(query, k, tenant=tenant)
        prompt = self.build_prompt(query, docs)
        out = self.generate_fn(prompt) if self.generate_fn else None
        return {"query": query, "docs": docs, "prompt": prompt,
                "response": out}


def lm_generate_fn(engine, vocab: int, max_len: int, detokenize=None):
    """Adapt a ``ServeEngine`` into ``RAGPipeline.generate_fn`` (hashed
    tokenizer, 16 new tokens)."""
    def fn(prompt: str) -> str:
        ids = encode_ids(prompt, vocab, max_len)
        ids = ids[ids > 0]
        out = engine.generate([ids], max_new_tokens=16)[0]
        if detokenize:
            return detokenize(out)
        return " ".join(f"<{t}>" for t in out)
    return fn
