"""End-to-end serving driver: continuous-batching LM serving, optionally
with RAG augmentation whose retrieval overlaps the decode loop — the port
of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 12 --max-new 16 --rag --index hnsw [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --rag --index hnsw \
        --index-dtype int8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --rag --index flat \
        --index-dtype int8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --rag --index ivf \
        --index-dtype int8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --rag --index tiered \
        [--device cpu]
    REPRO_TORCH_SHARD_DEVICES=cuda:0,cuda:0,cuda:0,cuda:0 PYTHONPATH=src \
        python -m repro_torch.launch.serve --rag --shards 4 --index hnsw \
        --index-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --rag --tenants 4 \
        --max-resident 2 --index-dtype int8 [--store-dir DIR] [--device cpu]

``--arch`` names any of the five LMs: ``llama3-8b`` and ``minitron-8b``
(dense, full attention), ``h2o-danube-3-4b`` (sliding-window attention,
its cache a ring of the window) and the MoE ``olmoe-1b-7b`` and
``granite-moe-3b-a800m``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --rag --index flat --index-dtype int8 [--device cpu]

The command line runs the architecture's smoke config with random weights
from ``--seed``. ``run(cfg, args)`` takes any ``LMConfig`` (``chip_smoke.py``
passes the full-width one). RAG requests arrive closed-loop (a bounded
window of outstanding requests is kept topped up); the run reports req/s,
tok/s, ``overlap_ratio`` and ``slot_occupancy``.

``--index flat`` serves exact search, ``--index hnsw`` the graph search,
``--index ivf`` the probed inverted lists (k-means trained at the first
search; its nlist, list cap and the probe's K are logged) and ``--index
tiered`` the host graph search through the two-tier store (its slow-tier
transactions are logged), each under the fp32, bf16 or int8 row codec
(``--index-dtype``; int8 over-fetches and reranks in fp32).
``--store-dir`` makes the index durable: the first run embeds the corpus
and snapshots the index on exit, a later run restores it warm (snapshot
+ WAL replay, IVF's trained centroids included) and only registers the
texts. ``--shards N`` partitions the index over N shards (key-hash
routing, a per-shard search on each shard's device, the tree merge); on
the card shard s goes on ``cuda:s``, and ``REPRO_TORCH_SHARD_DEVICES``
places the shards on fewer cards (``core/sharded.py:shard_devices``).
``--tenants N`` fronts the retriever with an ``IndexPool`` of N private
copies of the corpus over one shared device arena (a flat index a tenant;
``--max-resident`` caps the tenants resident in the arena, the rest page
to their stores); requests round-robin over the tenants and still
coalesce into one search a tick, and ``--store-dir`` becomes the pool's
root (a store a tenant), restored warm on the next start.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import IndexPool
from repro_torch.data.corpus import BUILTIN_CORPUS, HashingEncoder
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline
from repro_torch.store import IndexStore
from repro_torch.utils import logger, resolve_device

QUERIES = ("how does hnsw search work",
           "why is on device retrieval private",
           "what does efConstruction control")


def _power_of_two(v: str) -> int:
    n = int(v)
    if n < 1 or n & (n - 1):
        raise argparse.ArgumentTypeError(f"{v} is not a power of two")
    return n


def _serve_closed_loop(engine, queries, tenants, *, k, max_new):
    """Drive the engine closed-loop: keep up to 2*slots requests
    outstanding so retrieval for late arrivals overlaps decode ticks
    already running."""
    window = 2 * engine.slots
    pend = list(zip(queries, tenants))
    reqs = []
    t0 = time.perf_counter()
    while pend or engine._work_pending():
        while pend and sum(not r.done for r in reqs) < window:
            q, t = pend.pop(0)
            reqs.append(engine.submit_rag(q, k=k, tenant=t,
                                          max_new_tokens=max_new))
        engine.step()
    dt = time.perf_counter() - t0
    engine.poll()
    return reqs, dt


def _log_engine_stats(engine):
    s = engine.stats.as_dict()
    logger.info(
        f"engine: {s['ticks']} ticks ({s['decode_ticks']} decode, "
        f"{s['prefills']} prefills), overlap_ratio "
        f"{s['overlap_ratio']:.2f} ({s['overlapped_ticks']}/"
        f"{s['retrieval_ticks']} retrieval ticks behind decode), "
        f"slot_occupancy {s['slot_occupancy']:.2f}, "
        f"{s['re_retrievals']} epoch-guard re-retrievals")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--index", default="hnsw",
                    choices=("flat", "ivf", "hnsw", "tiered"),
                    help="VectorIndex backend for the RAG retriever")
    ap.add_argument("--index-dtype", default=None,
                    choices=("fp32", "bf16", "int8"),
                    help="row-storage codec of the index")
    ap.add_argument("--beam-impl", default=None, choices=("fused", "jnp"),
                    help="HNSW layer-0 beam: 'fused' runs the whole "
                         "ef-beam as one kernel launch; 'jnp' is the "
                         "per-hop reference loop. Default: fused")
    ap.add_argument("--retrieval-batch", type=_power_of_two, default=128,
                    help="RetrievalEngine bucket cap (power of two)")
    ap.add_argument("--retrieval-cache", type=int, default=1024,
                    help="RetrievalEngine LRU entries (0 disables)")
    ap.add_argument("--shards", type=int, default=None,
                    help="partition the index over N shards: CRUD routes "
                         "by key hash, queries fan out and merge. Default: "
                         "one device (or the stored shard count on a warm "
                         "restore). On the card shard s is cuda:s; "
                         "REPRO_TORCH_SHARD_DEVICES=cuda:0,cuda:0,... "
                         "places N shards on fewer cards")
    ap.add_argument("--store-dir", default=None,
                    help="durable IndexStore directory: restarts restore "
                         "the index warm (snapshot + WAL replay) instead "
                         "of re-embedding the corpus")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="auto-snapshot the store every N mutations "
                         "(0: only the final snapshot on exit)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant serving: front the retriever with an "
                         "IndexPool of N private copies of the corpus over "
                         "one shared device arena; requests round-robin "
                         "over the tenants and coalesce into one search a "
                         "tick. A flat index a tenant; --store-dir becomes "
                         "the pool root (a store a tenant)")
    ap.add_argument("--max-resident", type=int, default=64,
                    help="with --tenants: LRU cap on the tenants resident "
                         "in the arena; the rest page to their stores")
    ap.add_argument("--sampler", default="greedy",
                    choices=("greedy", "temperature"),
                    help="token sampler; temperature draws are seeded from "
                         "(--seed, request, position), so output is "
                         "independent of the admission schedule")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                         "plain versions of the kernels)")
    return ap.parse_args(argv)


def run(cfg, args: argparse.Namespace, corpus=BUILTIN_CORPUS) -> dict:
    """Serve ``args.requests`` requests with LM config ``cfg`` and, with
    ``--rag``, an index over ``corpus`` ([(key, text)]). Returns the
    engine, the pipeline (or None), the requests, the wall seconds of the
    serving loop and the tokens generated."""
    device = resolve_device(args.device)
    model = tf.init_lm(cfg, seed=args.seed, device=device)

    def build_engine(pipeline=None):
        return ServeEngine(model, cfg, pipeline=pipeline, slots=args.slots,
                           max_len=args.max_len, sampler=args.sampler,
                           temperature=args.temperature, seed=args.seed,
                           device=device)

    if not args.rag:
        engine = build_engine()
        rng = np.random.default_rng(args.seed)
        prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 24))
                   for _ in range(args.requests)]
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=args.max_new)
        dt = time.perf_counter() - t0
        logger.info(f"{args.requests} requests, {engine.tokens_out} tokens "
                    f"in {dt:.2f}s -> {engine.tokens_out / dt:.1f} tok/s "
                    f"({engine.ticks} engine ticks, {args.slots} slots)")
        if not all(len(o) == args.max_new for o in outs):
            raise RuntimeError("a request ended short of its token budget")
        return {"engine": engine, "rag": None, "reqs": outs, "seconds": dt,
                "tokens": engine.tokens_out}

    if args.tenants > 0:
        return _run_pool(args, corpus, device, build_engine)
    store = None
    if args.store_dir:
        store = IndexStore(args.store_dir,
                           snapshot_every=args.snapshot_every or None)
    rag = RAGPipeline(index_kind=args.index, index_store=store,
                      retrieval_batch=args.retrieval_batch,
                      retrieval_cache=args.retrieval_cache,
                      index_shards=args.shards,
                      index_dtype=args.index_dtype,
                      index_beam_impl=args.beam_impl, device=device)
    if rag.index.shard_count > 1:
        logger.info(f"index sharded over {rag.index.shard_count} devices "
                    f"(key-hash routing + fan-out search)")
    if rag.index.size:
        # warm restore: the embeddings came back from the store, epoch
        # included (the retrieval cache keys on it); only the text
        # side-table needs refilling
        logger.info(f"warm restore from {args.store_dir}: {rag.index.size} "
                    f"docs @ mutation_epoch {rag.index.mutation_epoch}")
        rag.register_texts(list(corpus))
    else:
        rag.add_documents(list(corpus))
    engine = build_engine(rag)
    queries = [QUERIES[i % len(QUERIES)] for i in range(args.requests)]
    reqs, dt = _serve_closed_loop(engine, queries, [None] * len(queries),
                                  k=3, max_new=args.max_new)
    for i, r in enumerate(reqs):
        logger.info(f"req {i}: retrieved {[d.key for d in r.docs]}")
    logger.info(f"RAG[{args.index}]: {args.requests} requests, "
                f"{engine.tokens_out} tokens in {dt:.2f}s "
                f"({args.requests / dt:.3f} req/s, "
                f"{engine.tokens_out / dt:.2f} tok/s, overlapped continuous "
                f"batching on {device})")
    _log_engine_stats(engine)
    rs = rag.retriever.stats.as_dict()
    logger.info(
        f"retrieval: {rs['requests']} requests in {rs['searches']} searches "
        f"({rs['searched_queries']} searched + {rs['padded_queries']} "
        f"bucket pad, cache hit rate {rs['hit_rate']:.2f})")
    if args.index == "ivf":
        p = rag.index.probe_plan()
        logger.info(f"ivf: nlist {p['nlist']}, list cap {p['cap']}, nprobe "
                    f"{p['nprobe']}: a search scores K = {p['nlist']} "
                    f"centroids, then K = {p['probe_k']} list slots a query")
    elif args.index == "tiered":
        logger.info(f"tiered: {rag.index.stats.as_dict()}")
    if store is not None:
        path = store.snapshot(rag.index)
        logger.info(f"store snapshot: {path} (epoch "
                    f"{rag.index.mutation_epoch}; next start restores warm)")
    return {"engine": engine, "rag": rag, "reqs": reqs, "seconds": dt,
            "tokens": engine.tokens_out}


def _run_pool(args, corpus, device, build_engine) -> dict:
    """``--rag --tenants N``: N tenants, each with a private copy of
    ``corpus`` in one ``IndexPool`` (a durable tenant found under
    ``--store-dir`` restores warm and only registers its texts), served
    with requests round-robin over the tenants."""
    encoder = HashingEncoder()
    pool = IndexPool(args.store_dir, dim=encoder.dim,
                     n_shards=args.shards or 1,
                     dtype=args.index_dtype or "fp32",
                     max_resident=args.max_resident,
                     snapshot_every=args.snapshot_every or None,
                     device=device)
    rag = RAGPipeline(encoder=encoder, index=pool,
                      retrieval_batch=args.retrieval_batch,
                      retrieval_cache=args.retrieval_cache)
    tids = [f"tenant{i}" for i in range(args.tenants)]
    t0 = time.perf_counter()
    for tid in tids:
        # each tenant holds a PRIVATE copy of the corpus: keys and
        # embeddings are namespaced, so identical texts never collide
        try:
            known = pool.size(tid)          # pages a durable tenant in
        except KeyError:
            known = 0
        if known:
            logger.info(f"{tid}: warm restore, {known} docs @ epoch "
                        f"{pool.epoch(tid)}")
            rag.register_texts(list(corpus), tenant=tid)
        else:
            rag.add_documents(list(corpus), tenant=tid)
    fill_s = time.perf_counter() - t0
    engine = build_engine(rag)
    queries = [QUERIES[i % len(QUERIES)] for i in range(args.requests)]
    tenants = [tids[i % len(tids)] for i in range(args.requests)]
    reqs, dt = _serve_closed_loop(engine, queries, tenants, k=3,
                                  max_new=args.max_new)
    for i, r in enumerate(reqs):
        logger.info(f"req {i} [{r.tenant}]: retrieved "
                    f"{[d.key for d in r.docs]}")
    logger.info(f"RAG[pool x{args.tenants}]: {args.requests} requests, "
                f"{engine.tokens_out} tokens in {dt:.2f}s "
                f"({args.requests / dt:.3f} req/s, "
                f"{engine.tokens_out / dt:.2f} tok/s, overlapped continuous "
                f"batching on {device}; tenants filled in {fill_s:.2f}s)")
    _log_engine_stats(engine)
    rs = rag.retriever.stats.as_dict()
    logger.info(
        f"retrieval: {rs['requests']} requests in {rs['searches']} searches "
        f"across {len(set(tenants))} tenants (cache hit rate "
        f"{rs['hit_rate']:.2f})")
    ps = pool.pool_stats()
    logger.info(f"pool: {ps['tenants']} tenants, {ps['resident']} resident, "
                f"{ps['arena_rows']} arena rows in {ps['slabs']} slabs "
                f"({ps['arena_bytes']} device bytes), {ps['evictions']} "
                f"evictions, {ps['admissions']} admissions")
    if args.store_dir:
        pool.flush()
        logger.info(f"pool flushed to {args.store_dir} (a snapshot a "
                    f"resident tenant; next start restores warm)")
    return {"engine": engine, "rag": rag, "reqs": reqs, "seconds": dt,
            "tokens": engine.tokens_out, "fill_seconds": fill_s}


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_smoke_config(args.arch), args)


if __name__ == "__main__":
    main()
