"""Batched retrieval serving layer — the retrieval-side twin of
``ServeEngine``'s continuous batching, ported from
``repro/serve/retrieval.py``.

  * requests are **submitted asynchronously** (``submit`` returns a
    ``RetrievalRequest`` handle resolved by a later tick);
  * each tick **coalesces** everything pending into per-(k, ef) groups and
    pads each group up to a **power-of-two batch bucket**, so the index
    sees a handful of batch shapes however traffic arrives;
  * each group runs as ONE ``index.query_batch`` search, and identical
    queries pending in the same tick share one row (``dedup_hits``);
  * an **LRU result cache** keyed on (tenant, query-vector hash, k, ef)
    serves repeats without a search. The tenant is the isolation
    boundary: two tenants submitting the same query vector never share a
    cached result (their corpora differ); it is None on a single index.
    The cache is validated against the index's ``mutation_epoch``: every
    insert/update/delete bumps the epoch and drops the cache, so a
    retracted document is never served from a stale entry. Fronting an
    ``IndexPool`` the check is per tenant (``pool.epoch(tid)``): one
    user's delete drops only their entries. The epoch is durable: a
    store-backed index restores at the epoch it died at and the engine
    adopts it at construction (never assuming 0), so cache validity
    survives restarts; ``compact()`` bumps the epoch, so it flushes the
    cache like any other mutation.

Fronting a ``core/tenancy.py:IndexPool`` (detected by its
``query_batch_multi``), every ``submit`` carries a ``tenant`` and each
per-(k, ef) tick group runs as ONE cross-tenant ``query_batch_multi``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np

from repro_torch.core.index import VectorIndex

# Bucket ladder: pending batches are padded up to the next power of two so
# the search sees at most log2(max_batch)+1 distinct batch shapes.
MAX_BATCH_DEFAULT = 128


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


@dataclasses.dataclass
class RetrievalRequest:
    """Handle returned by ``submit``; filled in when its tick executes."""
    rid: int
    query: np.ndarray                 # [D] f32 (contiguous; hashed for cache)
    k: int
    ef: int | None = None
    tenant: str | None = None         # IndexPool namespace (None: single)
    keys: list | None = None          # k entries, None-padded
    dists: np.ndarray | None = None   # [k] f32, INF-padded
    done: bool = False
    from_cache: bool = False
    error: Exception | None = None    # set if this request's search raised
    _ck: tuple | None = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class RetrievalStats:
    requests: int = 0
    ticks: int = 0
    searches: int = 0        # index searches (one per group per tick)
    searched_queries: int = 0  # real rows searched (excl. padding)
    padded_queries: int = 0    # rows added to reach the bucket size
    cache_hits: int = 0      # served from the LRU without any search
    dedup_hits: int = 0      # shared an identical in-flight tick-mate's row
    cache_misses: int = 0    # actually searched
    evictions: int = 0
    invalidations: int = 0   # whole-cache drops due to an epoch bump

    def as_dict(self) -> dict:
        served = self.cache_hits + self.dedup_hits
        total = max(served + self.cache_misses, 1)
        return {**dataclasses.asdict(self), "hit_rate": served / total}


class RetrievalEngine:
    """Continuous-batching front end over a ``VectorIndex`` or an
    ``IndexPool``.

    Parameters
    ----------
    index:      the VectorIndex (or IndexPool) to search.
    max_batch:  bucket ladder cap; also the most queries one search
                carries (bigger pending groups run in chunks).
    cache_size: LRU capacity in (query, k, ef) entries; 0 disables caching.
    """

    def __init__(self, index: VectorIndex, *,
                 max_batch: int = MAX_BATCH_DEFAULT, cache_size: int = 1024):
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, got {max_batch}")
        self.index = index
        # IndexPool front end: requests carry a tenant, searches go through
        # query_batch_multi, and cache validity is tracked per tenant
        self._multi = hasattr(index, "query_batch_multi")
        # a sharded index's one search IS its fan-out over the shards, and
        # a mutation routed to one shard still bumps the global epoch
        self.shards = getattr(index, "shard_count", 1)
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.queue: collections.deque[RetrievalRequest] = collections.deque()
        self.stats = RetrievalStats()
        self._next_rid = 0
        # LRU: (tenant, qhash, dim, k, ef) -> (keys, dists), valid only
        # for the epoch its tenant (or the whole index, when tenant is
        # None) was at when the entry was stored; a restored index starts
        # at its restored epoch
        self._cache: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._cache_epoch = index.mutation_epoch
        self._tenant_epochs: dict[str, int] = {}

    # ------------------------------------------------------------- intake
    def submit(self, query, k: int = 10, ef: int | None = None,
               tenant: str | None = None) -> RetrievalRequest:
        """Enqueue one query vector; returns a handle resolved by ``step``.
        Fronting an ``IndexPool``, ``tenant`` is required (there is no
        un-namespaced corpus to search); on a single index it is rejected
        (the backend cannot route it)."""
        if self._multi and tenant is None:
            raise ValueError("this engine fronts an IndexPool: "
                             "submit(..., tenant=...) is required")
        if not self._multi and tenant is not None:
            raise ValueError(f"tenant={tenant!r} needs an IndexPool index; "
                             f"{type(self.index).__name__} is single-tenant")
        q = np.ascontiguousarray(np.asarray(query, np.float32).reshape(-1))
        r = RetrievalRequest(self._next_rid, q, int(k), ef, tenant)
        self._next_rid += 1
        self.stats.requests += 1
        self.queue.append(r)
        return r

    # -------------------------------------------------------------- cache
    @staticmethod
    def _cache_key(r: RetrievalRequest) -> tuple:
        """Cache identity of one request; the leading tenant is the
        isolation boundary (identical query bytes under two tenants are
        two entries), and per-tenant invalidation drops exactly the keys
        it leads."""
        h = hashlib.blake2b(r.query.tobytes(), digest_size=16)
        return (r.tenant, h.digest(), r.query.shape[0], r.k, r.ef)

    def _check_epoch(self) -> None:
        """Drop cached results whose index state mutated since they were
        stored: delete() bumping the epoch is the privacy guarantee. On an
        ``IndexPool`` the check is per tenant: tenant A's delete drops A's
        entries and only A's."""
        if self._multi:
            for tid, known in list(self._tenant_epochs.items()):
                cur = self.index.epoch(tid)
                if cur != known:
                    dropped = [ck for ck in self._cache if ck[0] == tid]
                    for ck in dropped:
                        del self._cache[ck]
                    if dropped:
                        self.stats.invalidations += 1
                    self._tenant_epochs[tid] = cur
            self._cache_epoch = self.index.mutation_epoch
            return
        ep = self.index.mutation_epoch
        if ep != self._cache_epoch:
            if self._cache:
                self.stats.invalidations += 1
            self._cache.clear()
            self._cache_epoch = ep

    def _cache_get(self, key: tuple):
        if self.cache_size <= 0:
            return None
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key: tuple, keys: list, dists: np.ndarray) -> None:
        if self.cache_size <= 0:
            return
        if key in self._cache:
            self._cache.move_to_end(key)
        elif len(self._cache) >= self.cache_size:
            self._cache.popitem(last=False)
            self.stats.evictions += 1
        # private copies: callers own the request's keys/dists
        self._cache[key] = (list(keys), np.array(dists))

    # --------------------------------------------------------------- tick
    def step(self) -> int:
        """One engine tick: serve cache hits, coalesce the misses into
        power-of-two buckets per (k, ef), search, fan out. Returns the
        number of requests completed this tick.

        Identical queries pending in the SAME tick are deduplicated: one
        leader row is searched, followers share its result. If a search
        raises, every request of its group (and their followers) resolves
        with ``error`` set, the other groups still run, and the first
        exception re-raises after the tick settles."""
        if not self.queue:
            return 0
        self._check_epoch()
        pending, self.queue = list(self.queue), collections.deque()
        groups: dict[tuple, list[RetrievalRequest]] = {}
        followers: dict[tuple, list[RetrievalRequest]] = {}
        leaders: dict[tuple, RetrievalRequest] = {}
        done = 0
        for r in pending:
            r._ck = ck = self._cache_key(r)
            hit = self._cache_get(ck)
            if hit is not None:
                r.keys, r.dists = list(hit[0]), hit[1].copy()
                r.from_cache = r.done = True
                self.stats.cache_hits += 1
                done += 1
            elif ck in leaders:
                followers.setdefault(ck, []).append(r)
                self.stats.dedup_hits += 1
            else:
                leaders[ck] = r
                self.stats.cache_misses += 1
                groups.setdefault((r.k, r.ef), []).append(r)
        first_err: Exception | None = None
        for (k, ef), reqs in groups.items():
            for lo in range(0, len(reqs), self.max_batch):
                chunk = reqs[lo:lo + self.max_batch]
                try:
                    done += self._dispatch(chunk, k, ef)
                except Exception as e:
                    # resolve the whole group, then re-raise below
                    for r in chunk:
                        r.error, r.done = e, True
                        done += 1
                    first_err = first_err or e
        for ck, dups in followers.items():
            leader = leaders[ck]
            for r in dups:
                if leader.error is not None:
                    r.error = leader.error
                else:
                    r.keys, r.dists = list(leader.keys), leader.dists.copy()
                    r.from_cache = True
                r.done = True
                done += 1
        self.stats.ticks += 1
        if first_err is not None:
            raise first_err
        return done

    def _dispatch(self, reqs: list[RetrievalRequest], k: int,
                  ef: int | None) -> int:
        """Pad one group to its bucket, run ONE batched search, fan the
        rows back out to the callers and into the cache."""
        n = len(reqs)
        bucket = bucket_size(n, self.max_batch)
        q = np.stack([r.query for r in reqs])
        if bucket > n:
            # pad by repeating row 0: result rows are sliced off below
            q = np.concatenate([q, np.repeat(q[:1], bucket - n, axis=0)])
        kw = {} if ef is None else {"ef": ef}
        if self._multi:
            # the whole group, rows of different tenants, is one search;
            # padding rows take row 0's tenant along with its query
            tenants = [r.tenant for r in reqs] \
                + [reqs[0].tenant] * (bucket - n)
            keys, dists = self.index.query_batch_multi(q, tenants, k=k,
                                                       **kw)
        else:
            keys, dists = self.index.query_batch(q, k=k, **kw)
        dists = np.asarray(dists)
        self.stats.searches += 1
        self.stats.searched_queries += n
        self.stats.padded_queries += bucket - n
        for r, row_keys, row_d in zip(reqs, keys, dists):
            r.keys, r.dists = list(row_keys), np.asarray(row_d)
            r.done = True
            if self._multi:
                # host code is single-threaded, so the tenant's current
                # epoch IS the epoch the search ran at
                self._tenant_epochs.setdefault(r.tenant,
                                               self.index.epoch(r.tenant))
            self._cache_put(r._ck, r.keys, r.dists)
        return n

    # ---------------------------------------------------------- frontends
    @property
    def pending(self) -> int:
        """Requests submitted but not yet searched (queue depth)."""
        return len(self.queue)

    def poll(self) -> int:
        """Non-blocking pump: run at most ONE coalescing tick, and only if
        anything is pending; returns the number of requests completed."""
        if not self.queue:
            return 0
        return self.step()

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        ticks = 0
        while self.queue and ticks < max_ticks:
            self.step()
            ticks += 1

    def retrieve(self, queries, k: int = 10, ef: int | None = None,
                 tenants=None) -> list[RetrievalRequest]:
        """Batch convenience: submit all rows of [B, D], drain, return the
        resolved requests in submission order. ``tenants`` is one tenant
        for the whole batch or a list a row (IndexPool only)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if tenants is None or isinstance(tenants, str):
            tenants = [tenants] * q.shape[0]
        if len(tenants) != q.shape[0]:
            raise ValueError("queries/tenants length mismatch")
        reqs = [self.submit(row, k=k, ef=ef, tenant=t)
                for row, t in zip(q, tenants)]
        self.run_until_drained()
        return reqs

    def retrieve_one(self, query, k: int = 10, ef: int | None = None,
                     tenant: str | None = None) -> RetrievalRequest:
        """One query [D] through the engine (cache included): submit,
        drain, return its resolved request."""
        return self.retrieve(np.asarray(query, np.float32)[None], k, ef,
                             tenants=tenant)[0]
