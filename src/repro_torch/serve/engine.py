"""KV-cache serving engine: slot-based continuous batching with retrieval
overlapped behind the decode loop, ported from ``repro/serve/engine.py``.

A fixed pool of B slots decodes in lock step (one ``decode_step`` per
engine tick serves every active slot, one ``flash_decode`` launch per
layer); requests join free slots after a batched prefill and leave on
EOS/max-tokens, at which point queued requests are admitted — vLLM-style
continuous batching over fixed shapes.

RAG requests are first-class (:class:`RagRequest`): ``submit_rag`` enters
them into a tick state machine

    QUEUED -> RETRIEVING -> READY -> ACTIVE -> DONE

whose RETRIEVING stage runs on the already-async ``RetrievalEngine``
*behind* the in-flight decode launches: each tick the engine (1) submits
newly queued retrievals, (2) admits retrieval-completed requests into
free slots (batched prefill of the augmented prompt), (3) dispatches one
decode token for every active slot, and (4) pumps one retrieval
coalescing tick in the window between the decode dispatch and its
materialization — so retrieval latency for queued requests hides behind
decode compute and end-to-end req/s scales with ``slots`` instead of
paying retrieve-then-generate serially per batch.

Privacy under overlap: a prompt is only ever built from retrieval
results whose mutation epoch is still current at admission — if a
document is retracted while a request waits in READY, the request is
sent back to RETRIEVING (counted in ``stats.re_retrievals``), so a
deleted doc can never appear in a later-admitted prompt.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data.corpus import encode_ids
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device

# RagRequest lifecycle states (the tick state machine)
QUEUED = "queued"            # submitted, retrieval not yet dispatched
RETRIEVING = "retrieving"    # ANN search in flight on the RetrievalEngine
READY = "ready"              # docs available, waiting for a free slot
ACTIVE = "active"            # prompt prefilled into a slot, decoding
DONE = "done"                # finished (EOS / max tokens / cache full)


@dataclasses.dataclass
class Request:
    """Plain LM generation request (no retrieval stage)."""
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rag: "RagRequest | None" = None     # backlink when fronting a RagRequest


@dataclasses.dataclass
class RagRequest:
    """First-class RAG serving request (one per user query): query, ``k``,
    ``tenant`` (None on a single index; the namespace on an
    ``IndexPool``), generation budget and the lifecycle ``state``, driven
    by ``submit_rag()`` / ``poll()`` / ``run_until_drained()``."""
    query: str
    k: int = 3
    tenant: str | None = None
    max_new_tokens: int = 16
    eos_id: int | None = None
    rid: int = -1
    state: str = QUEUED
    docs: list = dataclasses.field(default_factory=list)
    prompt: str | None = None           # augmented prompt (built at admission)
    prompt_ids: np.ndarray | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    response: str | None = None
    done: bool = False
    _handle: object = dataclasses.field(default=None, repr=False)
    _epoch: int | None = dataclasses.field(default=None, repr=False)

    def result(self) -> dict:
        """The row shape ``generate_rag`` returns."""
        return {"query": self.query, "docs": self.docs,
                "prompt": self.prompt, "response": self.response}


@dataclasses.dataclass
class EngineStats:
    """Per-engine counters; ``as_dict`` derives the two headline ratios:

    ``overlap_ratio`` — fraction of retrieval coalescing ticks that ran
      while a decode dispatch was in flight (1.0 = every retrieval fully
      hidden behind decode; 0.0 = every retrieval paid serially, the old
      barrier behaviour).
    ``slot_occupancy`` — mean fraction of slots active per decode tick.
    """
    slots: int = 0
    ticks: int = 0
    decode_ticks: int = 0
    tokens_out: int = 0
    prefills: int = 0                # batched prefill dispatches
    admitted: int = 0                # requests admitted into slots
    finished: int = 0
    retrieval_ticks: int = 0         # retrieval coalescing ticks pumped
    overlapped_ticks: int = 0        # ...that ran during an in-flight decode
    re_retrievals: int = 0           # READY results invalidated by a mutation
    occupied_slot_ticks: int = 0     # sum over decode ticks of active slots

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["overlap_ratio"] = (self.overlapped_ticks
                              / max(self.retrieval_ticks, 1))
        d["slot_occupancy"] = (self.occupied_slot_ticks
                               / max(self.decode_ticks * self.slots, 1))
        return d


SAMPLERS = ("greedy", "temperature")


class ServeEngine:
    """Continuous-batching serving engine over one LM (+ optional RAG
    pipeline).

    Parameters
    ----------
    model:       a ``models.transformer.LM`` on ``device``.
    pipeline:    a ``RAGPipeline`` bound at construction; required for
                 ``submit_rag``. Plain ``submit``/``generate`` work
                 without one.
    sampler:     "greedy" (argmax) or "temperature" (categorical at
                 ``temperature``). Each temperature draw uses a
                 ``torch.Generator`` seeded from (seed, request rid, token
                 position) — NOT the slot or tick — so sampled output is
                 identical under any admission schedule. (The reference
                 folds the same triple into a JAX key; the two frameworks'
                 bits differ.)
    device:      where the cache lives and the model runs (default cuda).
    dtype:       the compute dtype of every prefill and decode tick and of
                 the cache (fp32, bf16 or fp16), as the reference's
                 ``dtype``; default the weights' own (the reference's
                 default, fp32, for the fp32 models it builds).
    """

    def __init__(self, model: tf.LM, cfg: LMConfig, *, pipeline=None,
                 slots: int = 4, max_len: int = 256, dtype=None,
                 sampler: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, device=None):
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; "
                             f"expected one of {SAMPLERS}")
        if sampler == "temperature" and temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.pipeline = pipeline
        self.slots = slots
        self.max_len = max_len
        self.dtype = model.dtype if dtype is None else dtype
        self.sampler = sampler
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.queue: deque[Request] = deque()          # plain LM requests
        self.rag_queue: deque[RagRequest] = deque()   # QUEUED
        self.retrieving: list[RagRequest] = []        # RETRIEVING
        self.ready: deque[RagRequest] = deque()       # READY (FIFO admission)
        self._finished: deque[RagRequest] = deque()   # for poll()
        self.active: list[Request | None] = [None] * slots
        self._next_rid = 0
        self.stats = EngineStats(slots=slots)
        self.cache = tf.init_cache(cfg, slots, max_len, self.dtype,
                                   self.device)

    # legacy counters (benchmarks/tests read these)
    @property
    def ticks(self) -> int:
        return self.stats.ticks

    @property
    def tokens_out(self) -> int:
        return self.stats.tokens_out

    # ------------------------------------------------------------ sampling
    def _sample(self, logits_row: np.ndarray, rid: int, t: int) -> int:
        """Sample token ``t`` of request ``rid`` from one [V] logits row.
        The draw's generator is seeded from (seed, rid, t) only, so it is
        a pure function of the request and position."""
        if self.sampler == "greedy":
            return int(np.argmax(logits_row))
        state = np.random.SeedSequence([self.seed, rid, t]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))
        probs = torch.softmax(
            torch.as_tensor(logits_row, dtype=torch.float32)
            / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    # ------------------------------------------------------------ intake
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               eos_id: int | None = None) -> Request:
        r = Request(self._next_rid, np.asarray(prompt_ids, np.int32),
                    max_new_tokens, eos_id)
        self._next_rid += 1
        self.queue.append(r)
        return r

    def submit_rag(self, query: str, *, k: int = 3,
                   tenant: str | None = None, max_new_tokens: int = 16,
                   eos_id: int | None = None) -> RagRequest:
        """Enqueue one RAG request; returns its handle immediately. Its
        retrieval runs on a later tick, behind in-flight decode work;
        watch ``.state`` / ``.done`` or collect it via :meth:`poll`."""
        if self.pipeline is None:
            raise ValueError("submit_rag needs a pipeline: construct "
                             "ServeEngine(..., pipeline=RAGPipeline(...))")
        r = RagRequest(query=query, k=k, tenant=tenant,
                       max_new_tokens=max_new_tokens, eos_id=eos_id,
                       rid=self._next_rid)
        self._next_rid += 1
        self.rag_queue.append(r)
        return r

    def poll(self) -> list[RagRequest]:
        """RAG requests finished since the last poll, completion order."""
        out = list(self._finished)
        self._finished.clear()
        return out

    # ------------------------------------------------------------ RAG flow
    def _pump_rag(self) -> None:
        """QUEUED -> RETRIEVING: hand every new request's query to the
        RetrievalEngine (submission only — no search, no blocking)."""
        while self.rag_queue:
            r = self.rag_queue.popleft()
            r._handle = self.pipeline.submit_retrieval(r.query, r.k,
                                                       tenant=r.tenant)
            r.state = RETRIEVING
            self.retrieving.append(r)

    def _poll_retrieval(self, decode_in_flight: bool) -> None:
        """Pump one retrieval coalescing tick (if anything is pending)
        and move resolved requests RETRIEVING -> READY. Called between the
        decode launches and the read of their logits, so the retrieval's
        host work overlaps the decode (``stats.overlapped_ticks``)."""
        if self.pipeline is None or not self.retrieving:
            return
        if self.pipeline.retriever.pending:
            self.pipeline.poll_retrieval()
            self.stats.retrieval_ticks += 1
            if decode_in_flight:
                self.stats.overlapped_ticks += 1
        still: list[RagRequest] = []
        for r in self.retrieving:
            if r._handle.done:
                # the search ran this tick and host code is
                # single-threaded: the current epoch IS the results' epoch
                r._epoch = self.pipeline.current_epoch(r.tenant)
                r.state = READY
                self.ready.append(r)
            else:
                still.append(r)
        self.retrieving = still

    def _prepare_rag(self, r: RagRequest) -> bool:
        """Materialize a READY request's docs + prompt for admission.
        Returns False (and re-queues the retrieval) if the index mutated
        since the search ran: a prompt is only built from results whose
        epoch is still current."""
        if self.pipeline.current_epoch(r.tenant) != r._epoch:
            r._handle = self.pipeline.submit_retrieval(r.query, r.k,
                                                       tenant=r.tenant)
            r._epoch = None
            r.state = RETRIEVING
            self.retrieving.append(r)
            self.stats.re_retrievals += 1
            return False
        r.docs = r._handle.docs()
        r.prompt = self.pipeline.build_prompt(r.query, r.docs)
        ids = encode_ids(r.prompt, self.cfg.vocab, self.max_len - 1)
        r.prompt_ids = ids[ids > 0]
        return True

    # ------------------------------------------------------------ admission
    def _admit(self):
        """Fill free slots: batched prefill of up to ``slots`` prompts.
        READY RAG requests admit first, then the plain queue."""
        free = [i for i, a in enumerate(self.active) if a is None]
        if not free:
            return
        take: list[Request] = []
        while len(take) < len(free) and (self.ready or self.queue):
            if self.ready:
                rr = self.ready.popleft()
                if not self._prepare_rag(rr):
                    continue            # epoch moved: back to RETRIEVING
                req = Request(rr.rid, rr.prompt_ids, rr.max_new_tokens,
                              rr.eos_id, out_tokens=rr.out_tokens, rag=rr)
                rr.state = ACTIVE
                take.append(req)
            else:
                take.append(self.queue.popleft())
        if not take:
            return
        # Fixed-shape prefill: always ``slots`` rows, prompt length bucketed
        # to a power of two (capped at max_len-1). Pad rows/positions are
        # dead: prompt_lens picks the real last position and cur_len masks
        # pad KV out of every later decode.
        need = max(len(r.prompt) for r in take)
        plen = 16
        while plen < need:
            plen *= 2
        plen = max(need, min(plen, self.max_len - 1))
        batch = np.zeros((self.slots, plen), np.int32)
        lens = np.zeros(self.slots, np.int32)
        for j, r in enumerate(take):
            batch[j, : len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        logits, cache = tf.prefill(
            self.model, torch.as_tensor(batch).to(self.device),
            max_len=self.max_len, prompt_lens=torch.as_tensor(lens),
            dtype=self.dtype)
        first = logits[:, 0].float().cpu().numpy()          # [B,V]
        self.stats.prefills += 1
        span = cache.k.shape[2]
        for j, r in enumerate(take):
            slot = free[j]
            self.active[slot] = r
            self.stats.admitted += 1
            r.out_tokens.append(self._sample(first[j], r.rid, 0))
            # copy this request's prefilled KV rows (and, under
            # kv_quant, their scales) into its slot
            self.cache.k[:, slot, :span] = cache.k[:, j]
            self.cache.v[:, slot, :span] = cache.v[:, j]
            if cache.k_scale is not None:
                self.cache.k_scale[:, slot, :span] = cache.k_scale[:, j]
                self.cache.v_scale[:, slot, :span] = cache.v_scale[:, j]
            self.cache.cur_len[slot] = int(lens[j])

    # ------------------------------------------------------------- tick
    def step(self):
        """One engine tick of the overlapped loop:

        1. QUEUED -> RETRIEVING (submit new retrievals, non-blocking)
        2. READY -> ACTIVE (batched prefill into free slots)
        3. launch one decode token for every active slot (async)
        4. pump one retrieval coalescing tick *while the decode runs*
        5. read the logits back, sample, evict finished slots
        """
        if self.pipeline is not None:
            self._pump_rag()
        self._admit()
        n_active = sum(a is not None for a in self.active)
        logits = None
        if n_active:
            last = np.zeros((self.slots, 1), np.int32)
            for i, r in enumerate(self.active):
                if r is not None and r.out_tokens:
                    last[i, 0] = r.out_tokens[-1]
            logits, self.cache = tf.decode_step(
                self.model, torch.as_tensor(last).to(self.device), self.cache,
                dtype=self.dtype)
            self.stats.decode_ticks += 1
            self.stats.occupied_slot_ticks += n_active
        # ---- overlap window: retrieval runs behind the launched decode
        self._poll_retrieval(decode_in_flight=bool(n_active))
        self.stats.ticks += 1
        if logits is None:
            return
        nxt = logits[:, 0].float().cpu().numpy()     # waits for the decode
        cur = self.cache.cur_len.cpu().numpy()
        for i, r in enumerate(self.active):
            if r is None:
                continue
            tok = self._sample(nxt[i], r.rid, len(r.out_tokens))
            r.out_tokens.append(tok)
            self.stats.tokens_out += 1
            if (r.eos_id is not None and tok == r.eos_id) \
                    or len(r.out_tokens) >= r.max_new_tokens \
                    or cur[i] >= self.max_len - 1:
                r.done = True
                if r.rag is not None:
                    rr = r.rag
                    rr.state = DONE
                    rr.done = True
                    rr.response = " ".join(f"<{t}>" for t in rr.out_tokens)
                    self._finished.append(rr)
                self.stats.finished += 1
                self.active[i] = None
                # park the slot at position 0 (keeps idle decodes
                # in-bounds; re-admission overwrites + re-masks the rows)
                self.cache.cur_len[i] = 0

    def _work_pending(self) -> bool:
        return bool(self.queue or self.rag_queue or self.retrieving
                    or self.ready or any(a is not None for a in self.active))

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        while self._work_pending() and self.stats.ticks < max_ticks:
            self.step()

    def generate(self, prompts: list,
                 max_new_tokens: int = 16) -> list[list[int]]:
        reqs = [self.submit(p, max_new_tokens) for p in prompts]
        self.run_until_drained()
        return [r.out_tokens for r in reqs]

    # ------------------------------------------------------------ RAG shim
    def generate_rag(self, pipeline, queries: list[str], *, k: int = 3,
                     max_new_tokens: int = 16,
                     tenants: list[str] | None = None) -> list[dict]:
        """Batch call over the request API: binds ``pipeline`` (if none is
        bound yet), submits one ``RagRequest`` a query, drains, and
        returns each request's ``result()``. ``tenants`` maps onto each
        request's ``tenant``."""
        if self.pipeline is None:
            self.pipeline = pipeline
        elif self.pipeline is not pipeline:
            raise ValueError(
                "engine is already bound to a different pipeline; "
                "construct one ServeEngine(..., pipeline=...) per pipeline")
        ts = tenants if tenants is not None else [None] * len(queries)
        if len(ts) != len(queries):
            raise ValueError("queries/tenants length mismatch")
        reqs = [self.submit_rag(q, k=k, tenant=t,
                                max_new_tokens=max_new_tokens)
                for q, t in zip(queries, ts)]
        self.run_until_drained()
        self.poll()                      # batch callers never poll
        return [r.result() for r in reqs]
