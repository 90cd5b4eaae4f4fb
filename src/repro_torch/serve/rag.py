"""RAG pipeline — the paper's end-to-end loop (C4, §2 RAG Playground),
ported from ``repro/serve/rag.py``:

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
``generate_fn``; ``lm_generate_fn`` adapts a ``ServeEngine``).

Multi-tenant serving: construct with ``index=IndexPool(...)`` and every
data and retrieve verb takes a ``tenant``. Each user gets a private
corpus (documents, embeddings and cached results are namespaced) while
one shared device arena and one engine serve all of them; retrieval for
a batch of different tenants still coalesces into one search a tick.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.index import VectorIndex, make_index
from repro_torch.data.corpus import DocumentStore, HashingEncoder, encode_ids
from repro_torch.core.tenancy import tenant_key
from repro_torch.serve.retrieval import RetrievalEngine

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
    tenant: str | None
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
        return self._pipeline._materialize(
            self.request.keys, self.request.dists, self.tenant)


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
        # pool mode: the index is an IndexPool and every verb below takes a
        # tenant; the document store's text keys are namespaced as the
        # pool namespaces the vectors, so two tenants' texts never collide
        self.pool_mode = hasattr(self.index, "query_batch_multi")
        self.retriever = RetrievalEngine(self.index,
                                         max_batch=retrieval_batch,
                                         cache_size=retrieval_cache)

    def _tid(self, tenant: str | None) -> str | None:
        if self.pool_mode:
            if tenant is None:
                raise ValueError(
                    "pipeline fronts an IndexPool: pass tenant=")
            return tenant
        if tenant is not None:
            raise ValueError("tenant= requires an IndexPool index")
        return None

    def _doc_key(self, key: str, tenant: str | None) -> str:
        return key if tenant is None else tenant_key(tenant, key)

    # --------------------------------------------------------------- data
    def add_documents(self, docs: list[tuple[str, str]],
                      tenant: str | None = None):
        """docs: [(key, text)] — embed + index + store (bulk write, C3)."""
        tenant = self._tid(tenant)
        keys = [k for k, _ in docs]
        vecs = self.encoder.encode([t for _, t in docs])
        if self.pool_mode:
            self.index.bulk_insert(tenant, keys, vecs)
        else:
            self.index.bulk_insert(keys, vecs)
        for k, t in docs:
            self.store.add(self._doc_key(k, tenant), t)

    def register_texts(self, docs: list[tuple[str, str]],
                       tenant: str | None = None):
        """Warm-restart companion to ``add_documents``: (re)populate the
        text store WITHOUT touching the index. A warm-restored index
        already holds the embeddings; re-inserting them would cost WAL
        records and epoch bumps for nothing. Only documents the index
        knows are registered."""
        tenant = self._tid(tenant)
        for k, t in docs:
            known = (self.index.contains(tenant, k) if self.pool_mode
                     else k in self.index)
            if known:
                self.store.add(self._doc_key(k, tenant), t)

    def add_document(self, key: str, text: str, tenant: str | None = None):
        tenant = self._tid(tenant)
        vec = self.encoder.encode(text)[0]
        if self.pool_mode:
            self.index.insert(tenant, key, vec)
        else:
            self.index.insert(key, vec)
        self.store.add(self._doc_key(key, tenant), text)

    def update_document(self, key: str, text: str,
                        tenant: str | None = None):
        """Re-embed + replace an indexed document in place."""
        tenant = self._tid(tenant)
        vec = self.encoder.encode(text)[0]
        if self.pool_mode:
            self.index.update(tenant, key, vec)
        else:
            self.index.update(key, vec)
        self.store.add(self._doc_key(key, tenant), text)

    def delete_document(self, key: str, tenant: str | None = None):
        """Retract a document: tombstoned in the index, purged from the
        store — it can never be retrieved into a prompt again."""
        tenant = self._tid(tenant)
        if self.pool_mode:
            self.index.delete(tenant, key)
        else:
            self.index.delete(key)
        self.store.remove(self._doc_key(key, tenant))

    # ------------------------------------------------------------ retrieve
    def _size_for(self, tenant: str | None) -> int:
        """Live rows of the (tenant's) corpus: one accessor for the pool
        and the single index, so every retrieve verb shares one path."""
        if self.pool_mode:
            if tenant is None:
                raise ValueError(
                    "pipeline fronts an IndexPool: pass tenant=")
            return self.index.size(tenant)
        if tenant is not None:
            raise ValueError("tenant= requires an IndexPool index")
        return self.index.size

    def current_epoch(self, tenant: str | None = None) -> int:
        """Mutation epoch governing retrieval validity for ``tenant`` (the
        whole index when None): a prompt is only built from results whose
        epoch is still current."""
        if self.pool_mode and tenant is not None:
            return self.index.epoch(tenant)
        return self.index.mutation_epoch

    def _materialize(self, keys, dists, tenant: str | None
                     ) -> list[RetrievedDoc]:
        return [RetrievedDoc(key,
                             self.store.get(self._doc_key(key, tenant)).text,
                             float(d))
                for key, d in zip(keys, dists) if key is not None]

    def submit_retrieval(self, query: str, k: int = 3,
                         tenant: str | None = None) -> PendingRetrieval:
        """Async retrieval entry point: encode the query and enqueue it on
        the RetrievalEngine without searching. An empty corpus resolves at
        once with no docs."""
        size = self._size_for(tenant)
        if size == 0:
            return PendingRetrieval(None, tenant, self)
        qv = self.encoder.encode([query])[0]
        req = self.retriever.submit(qv, k=min(k, size), tenant=tenant)
        return PendingRetrieval(req, tenant, self)

    def poll_retrieval(self) -> int:
        """Run at most one RetrievalEngine coalescing tick."""
        return self.retriever.poll()

    def retrieve(self, query: str, k: int = 3,
                 tenant: str | None = None) -> list[RetrievedDoc]:
        return self.retrieve_batch([query], k,
                                   tenants=None if tenant is None
                                   else [tenant])[0]

    def retrieve_batch(self, queries: list[str], k: int = 3,
                       tenants: list[str] | None = None
                       ) -> list[list[RetrievedDoc]]:
        """Retrieve for many queries in ONE RetrievalEngine tick.
        ``tenants`` is a per-query tenant list (None: single index);
        requests of different tenants coalesce into the same search."""
        if tenants is None:
            tenants = [None] * len(queries)
        if len(tenants) != len(queries):
            raise ValueError("queries/tenants length mismatch")
        pend = [self.submit_retrieval(q, k, tenant=t)
                for q, t in zip(queries, tenants)]
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
