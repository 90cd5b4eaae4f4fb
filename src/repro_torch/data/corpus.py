"""Document store + tokenizer + hashing embedder for the RAG pipeline.

A copy of the reference's ``repro/data/corpus.py`` (all numpy), so the
embeddings and token ids are bit-identical in both packages. The project
ships no pretrained weights, so the embedder is a deterministic *hashed
bag-of-ngrams random projection* (the same family as classic LSA/feature
hashing) in place of GTE-small in the paper's pipeline.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np

_WORD = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    return _WORD.findall(text.lower())


def hash_token(tok: str, vocab: int) -> int:
    h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % vocab


def encode_ids(text: str, vocab: int, max_len: int) -> np.ndarray:
    ids = [hash_token(t, vocab - 2) + 2 for t in tokenize(text)][:max_len]
    out = np.zeros(max_len, np.int32)          # 0 = pad
    out[: len(ids)] = ids
    return out


class HashingEncoder:
    """text -> unit-norm dense vector. Hashed 1-2gram counts -> fixed random
    projection (seeded): deterministic, vocabulary-free, no training."""

    def __init__(self, dim: int = 384, buckets: int = 2 ** 18, seed: int = 0):
        self.dim = dim
        self.buckets = buckets
        rng = np.random.default_rng(seed)
        # projection realised lazily per bucket via hashing trick:
        # row r of the projection = rademacher stream seeded by (seed, r)
        self.seed = seed

    def _bucket_vec(self, b: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, b]))
        return rng.standard_normal(self.dim).astype(np.float32)

    def encode(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            toks = tokenize(t)
            grams = toks + [a + "_" + b for a, b in zip(toks, toks[1:])]
            for g in grams:
                out[i] += self._bucket_vec(hash_token(g, self.buckets))
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out


@dataclasses.dataclass
class Document:
    key: str
    text: str


class DocumentStore:
    """Key-value raw-document store — the IndexedDB counterpart (§2.1: raw
    docs in IndexedDB, HNSW keys match)."""

    def __init__(self):
        self._docs: dict[str, Document] = {}

    def add(self, key: str, text: str):
        self._docs[key] = Document(key, text)

    def get(self, key: str) -> Document:
        return self._docs[key]

    def remove(self, key: str):
        del self._docs[key]

    def __len__(self):
        return len(self._docs)

    def keys(self) -> list[str]:
        return list(self._docs)

    def texts(self) -> list[str]:
        return [d.text for d in self._docs.values()]


# a small built-in corpus so examples run offline (paper/table facts)
BUILTIN_CORPUS = [
    ("hnsw-0", "HNSW builds a multilayer graph where each node keeps at most "
               "M neighbors per layer and search descends greedily from the "
               "top layer."),
    ("hnsw-1", "The efConstruction parameter controls how many candidates "
               "are examined while inserting a new element into an HNSW "
               "index."),
    ("hnsw-2", "Query-time recall of HNSW rises with the efSearch beam "
               "width at the cost of more distance computations."),
    ("mememo-0", "MeMemo stores vector payloads in IndexedDB and keeps only "
                 "keys and the HNSW graph topology in RAM."),
    ("mememo-1", "MeMemo prefetches p graph neighbors of a missed element "
                 "in one IndexedDB transaction to amortize slow storage "
                 "reads."),
    ("mememo-2", "Inserting one million 384 dimensional vectors with M 5 "
                 "and efConstruction 20 took about 94 minutes in Chrome."),
    ("rag-0", "Retrieval augmented generation grounds a language model "
              "response with documents fetched from an external knowledge "
              "base."),
    ("rag-1", "RAG Playground lets developers paste a query, inspect "
              "retrieved documents, and edit the prompt template with user "
              "and context placeholders."),
    ("tpu-0", "A TPU v5e chip reaches 197 teraflops in bfloat16 with 819 "
              "gigabytes per second of HBM bandwidth."),
    ("tpu-1", "Pallas kernels tile HBM arrays into VMEM blocks so the MXU "
              "systolic array stays fed."),
    ("priv-0", "On device retrieval keeps personal documents private "
               "because no query or document ever leaves the client."),
    ("priv-1", "Personal finance, education, and medicine are domains "
               "where data privacy forbids server side retrieval."),
]


def builtin_store() -> DocumentStore:
    store = DocumentStore()
    for k, t in BUILTIN_CORPUS:
        store.add(k, t)
    return store
