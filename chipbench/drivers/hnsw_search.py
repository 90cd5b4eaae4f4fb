"""Driver of batched HNSW search: one closed-loop caller sends batches of
queries to ``HNSW.query_batch`` over an index built in set-up.

Configuration keys: ``rows``, ``dim``, ``clusters``, ``center_scale``
(the seeded mixture), ``metric``, ``M``, ``ef_construction``,
``ef_search``, ``dtype`` (the index's row codec), ``limits``. Traffic
keys: ``batch``, ``k``, ``ef``, ``pool_batches`` (distinct batches drawn
before the window and cycled), ``check_batches`` (answered batches the
reference judges: a seeded sample of the window's calls, kept as they
come), ``trace_at``/``trace_s`` (the traced stretch: its start as a
share of the window, its seconds), ``work_launches`` (traced beam
launches whose work is counted).

The record it returns holds what the metric readers read: ``setup_s``,
``window_s``, ``latencies_s`` (every batch in the window outside the
traced stretch), ``queries``, ``cpu_s`` (the caller thread's CPU seconds
in the window), ``build_s``/``build_rows``; untraced on the card
``card_busy`` (the card's busy seconds over the whole window and the
operations counted), and with tracing ``trace``, ``beam_work`` (bytes
and operations a launch)."""
from __future__ import annotations

import gc
import time

import numpy as np

from chipbench.lib import arith, beam_work, reference, traffic
from chipbench.lib.trace import CardClock, Tracer, reduce

SPAN = "chipbench.query_batch"


def build_index(cfg: dict, rows_host: np.ndarray, device):
    """The system under test: ``cfg``'s HNSW over the rows, bulk-built."""
    from repro_torch.core.interface import HNSW
    idx = HNSW(cfg["metric"], M=cfg["M"],
               ef_construction=cfg["ef_construction"],
               ef_search=cfg["ef_search"], use_bulk_build=True,
               dtype=cfg["dtype"], device=device)
    idx.bulk_insert([f"r{i}" for i in range(len(rows_host))], rows_host)
    return idx


def make_inputs(cfg: dict, mix: dict, seed: int, device):
    """(rows [N, D], query pool [P, B, D]) on ``device``, from the seed."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows, centers = traffic.mixture(cfg["rows"], cfg["dim"],
                                    cfg["clusters"], cfg["center_scale"],
                                    gen, device)
    p, b = mix["pool_batches"], mix["batch"]
    pool = traffic.draw_near(centers, p * b, gen).view(p, b, cfg["dim"])
    return rows, pool


def graph_of(idx, device) -> dict:
    """The built graph, from the index's saved state (its store format),
    on ``device``: ``neighbors0``, ``upper``, ``levels``, ``deleted``
    over the n rows, ``entry``, ``max_level``, and ``rows``, the input
    row of each graph id (its key ``r<row>``)."""
    import torch
    arrays, meta = idx.state_dict()
    n = meta["n"]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)
    rows = np.fromiter((int(key[1:]) for key in meta["keys"]), np.int64, n)
    return dict(neighbors0=dev(arrays["neighbors0"][:n]),
                upper=dev(arrays["upper"][:, :n]),
                levels=dev(arrays["levels"][:n]),
                deleted=dev(arrays["deleted"][:n]), entry=meta["entry"],
                max_level=meta["max_level"], rows=dev(rows))


def judge(rows, pool, answers: list, k: int, ef: int, limits: dict,
          graph: dict) -> tuple[dict, dict]:
    """Hold answered batches [(pool index, keys, dists)] against the
    reference -> (checks, info). ``dist_gap``: the widest gap between an
    answered distance and the reference's distance of that key's row;
    ``bad_answers``: queries whose answer lacks k distinct known keys in
    ascending distance order; ``traversal_miss``: the share of answered
    keys that the reference's HNSW search over the same graph does not
    return; ``graph_faults``: the graph's broken invariants. Recall@k
    against the exact top-k is reported beside them, not compared."""
    import torch
    unit = reference.unit_rows(rows)
    by_id = unit[graph["rows"]]
    gap, bad, hit, miss, total = 0.0, 0, 0, 0, 0
    for b, keys, dists in answers:
        q = pool[b]
        ids = np.full((len(keys), k), -1, np.int64)
        for i, row in enumerate(keys):
            got = [int(x[1:]) if isinstance(x, str) and x[:1] == "r" else -1
                   for x in row][:k]
            ids[i, :len(got)] = got
            d = np.asarray(dists[i][:k], np.float64)
            if (len(got) != k or min(got) < 0 or len(set(got)) != k
                    or np.any(np.diff(d) < 0)):
                bad += 1
        ok = torch.as_tensor(ids, device=q.device).clamp_min(0)
        ref_d = reference.row_distances(unit, q, ok)
        d_prog = torch.as_tensor(np.asarray(dists, np.float32)[:, :k],
                                 device=q.device)
        gap = max(gap, float((ref_d - d_prog).abs().max()))
        walk = reference.hnsw_search(by_id, graph, q, k, ef)
        walk = torch.where(walk >= 0, graph["rows"][walk.clamp_min(0)], -1)
        miss += int((~(ok[:, :, None] == walk[:, None, :]).any(-1)).sum())
        true_ids, _ = reference.exact_topk(unit, q, k)
        hit += int((ok[:, :, None] == true_ids[:, None, :]).any(-1).sum())
        total += ok.numel()
    checks = {"dist_gap": {"value": gap, "limit": limits["dist_gap"]},
              "bad_answers": {"value": bad, "limit": limits["bad_answers"]},
              "traversal_miss": {"value": miss / max(total, 1),
                                 "limit": limits["traversal_miss"]},
              "graph_faults": {"value": reference.graph_faults(graph),
                               "limit": limits["graph_faults"]}}
    return checks, {"recall_at_k": hit / max(total, 1),
                    "judged_queries": total // k}


class Reservoir:
    """A seeded uniform sample of ``size`` of the items offered, held as
    they come (Algorithm R): memory stays fixed however long the window."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = size, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        t0: float, device, smi=None) -> dict:
    import torch
    from repro_torch.kernels import ops

    rows, pool = make_inputs(cfg, mix, seed, device)
    pool_host = pool.cpu().numpy()
    rows_host = rows.cpu().numpy()
    t_build = time.perf_counter()
    idx = build_index(cfg, rows_host, device)
    build_s = time.perf_counter() - t_build
    del rows_host
    k, ef, b = mix["k"], mix["ef"], mix["batch"]
    for i in range(3):                  # the first upload, and the shape
        idx.query_batch(pool_host[i], k=k, ef=ef)
    tracer = Tracer(torch) if trace else None
    captured: list[dict] = []
    if trace:
        tracer.warm()
        orig_beam = ops.beam_search

        def beam_capture(vectors, neighbors0, q, ep, ep_dist, **kw):
            if capturing[0] and len(captured) < mix["work_launches"]:
                captured.append(dict(vectors=vectors, neighbors0=neighbors0,
                                     q=q.clone(), ep=ep.clone(),
                                     ep_dist=ep_dist.clone(), kw=dict(kw)))
            return orig_beam(vectors, neighbors0, q, ep, ep_dist, **kw)
        capturing = [False]
        ops.beam_search = beam_capture
    on_card = torch.device(device).type == "cuda"
    clock = None
    if on_card and not trace:
        clock = CardClock(torch)
        clock.warm()
    if on_card:
        torch.cuda.synchronize(device)
    if smi is not None:
        smi.start()
    kept = Reservoir(mix["check_batches"], seed)
    lat = []
    # what set-up left (the rows' keys, the builder's arrays) is never
    # freed: keep the collector from scanning it again in the window
    gc.collect()
    gc.freeze()
    p = len(pool_host)
    if clock is not None:
        clock.start()
    cpu0 = time.thread_time()
    t_start = time.perf_counter()
    call = 0
    traced = False
    while True:
        now = time.perf_counter()
        if now - t_start >= seconds:
            break
        if trace and not traced and now - t_start >= mix["trace_at"] * seconds:
            traced = True
            capturing[0] = True
            from torch.profiler import record_function
            with tracer.stretch():
                t_end_tr = now + mix["trace_s"]
                while time.perf_counter() < t_end_tr:
                    with record_function(SPAN):
                        out = idx.query_batch(pool_host[call % p], k=k, ef=ef)
                    kept.offer((call % p, *out))
                    call += 1
            capturing[0] = False
            continue
        t1 = time.perf_counter()
        out = idx.query_batch(pool_host[call % p], k=k, ef=ef)
        lat.append(time.perf_counter() - t1)
        kept.offer((call % p, *out))
        call += 1
    t_end = time.perf_counter()
    cpu_s = time.thread_time() - cpu0
    busy = clock.stop() if clock is not None else None
    card = smi.stop() if smi is not None else {}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if trace:
        ops.beam_search = orig_beam
    rec = dict(setup_s=t_start - t0, window_s=t_end - t_start,
               latencies_s=lat, queries=call * b, calls=call, cpu_s=cpu_s,
               build_s=build_s, build_rows=cfg["rows"], memory_peak_bytes=peak,
               attempted=call * b, failed=0, smi=card)
    if busy is not None:
        rec["card_busy"] = busy
    if trace:
        rec["trace"] = reduce(tracer.events, spans=(SPAN,),
                              kernels=("beam_search",))
        rec["beam_work"] = beam_launch_work(captured, cfg, mix, rows.shape[1])
    captured.clear()
    gc.unfreeze()
    graph = graph_of(idx, rows.device)
    del idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, info = judge(rows, pool, kept.items, k, ef, cfg["limits"], graph)
    rec.update(checks=checks, info=info,
               correct=bool(kept.items) and all(
                   c["value"] <= c["limit"] for c in checks.values()))
    return rec


def beam_launch_work(captured: list[dict], cfg: dict, mix: dict,
                     d: int) -> dict | None:
    """Mean bytes and operations a traced ``beam_search`` launch needs
    (``beam_work.traversal`` on its own inputs)."""
    if not captured:
        return None
    out = []
    for c in captured:
        kw = c["kw"]
        w = beam_work.traversal(c["vectors"], c["neighbors0"], c["q"],
                                c["ep"], c["ep_dist"], ef=kw["ef"],
                                metric=kw.get("metric", "cosine"),
                                scales=kw.get("scales"),
                                expand_t=kw.get("expand_t", 4),
                                max_iters=kw.get("max_iters"))
        row_bytes = c["vectors"].element_size() * d + (
            4 if kw.get("scales") is not None else 0)
        nbytes, flops = arith.beam_search_work(
            w["rows"], w["lists"], w["pairs"], d=d,
            m2=c["neighbors0"].shape[1], b=c["q"].shape[0], ef=kw["ef"],
            row_bytes=row_bytes)
        out.append((nbytes, flops, w))
    n = len(out)
    return {"bytes": sum(x[0] for x in out) / n,
            "flops": sum(x[1] for x in out) / n,
            "distinct_rows": sum(x[2]["rows"] for x in out) / n,
            "launches_counted": n}
