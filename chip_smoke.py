#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (none catches an exception; any failure exits non-zero):

1. Environment: the card's name and power limit, torch/CUDA versions, the
   compute capability (must be 9.0), and the build of every hand kernel
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all in
   parallel), timed.
2. Kernels against their plain PyTorch versions at the main path's real
   sizes — MeMemo's 1M x 384 cosine corpus (configs/mememo.py) and the
   llama3-8b decode geometry — each timed with CUDA events beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call.
3. The served path, through ``repro_torch.launch.serve.run`` with
   ``--rag --index hnsw``: full-width llama3-8b (all 32 layers, fp32
   random weights from a seeded ``torch.Generator``) over the built-in
   corpus plus 2,000 synthetic documents, 8 requests, 16 new tokens each,
   4 slots. The kernel launch counters are zeroed just before and read
   just after; every kernel of the path must have launched. The retrieved
   keys must equal a CPU search of the same host graph (plain versions).
   At the served cache geometry (slots x max_len, each slot at its own
   depth) the flash kernel must match its plain version, and one
   full-width ``decode_step`` must agree between the flash kernel and the
   dense path.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit): HBM rate and
# the fp32 rate outside the tensor cores, which every kernel here uses
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_VECTORS, DIM = 1_000_000, 384          # configs/mememo.py
N_QUERIES, K_GATHER, M2, EF = 1024, 32, 32, 64
DEC_B, DEC_H, DEC_KVH, DEC_DH, DEC_S = 8, 32, 8, 128, 8192
SYNTHETIC_DOCS = 2000


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the HBM rate or
    operations over the fp32 rate, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_corpus(n: int, seed: int) -> list[tuple[str, str]]:
    """``n`` distinct documents of 12-30 words drawn from a seeded RNG over
    the built-in corpus's vocabulary plus filler words."""
    import numpy as np
    from repro_torch.data.corpus import BUILTIN_CORPUS, tokenize

    vocab = sorted({w for _, t in BUILTIN_CORPUS for w in tokenize(t)}
                   | {f"topic{i}" for i in range(200)})
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = rng.choice(vocab, size=int(rng.integers(12, 31)))
        docs.append((f"syn-{i}", f"note {i} " + " ".join(words)))
    return docs


# ---------------------------------------------------------------------------
def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    cap = torch.cuda.get_device_capability(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"capability {cap}, {torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise SystemExit(f"needs compute capability 9.0 (Hopper), got {cap}")
    # full-fp32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f}s wall, per source "
        + json.dumps({k: round(v, 2) for k, v in took.items()}))
    return smi


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version at the main path's sizes."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    vec = unit(torch.randn(N_VECTORS, DIM, device=dev, generator=gen))
    q = unit(torch.randn(N_QUERIES, DIM, device=dev, generator=gen))

    # -- gather_distance ------------------------------------------------
    ids = torch.randint(0, N_VECTORS, (N_QUERIES, K_GATHER), device=dev,
                        generator=gen, dtype=torch.int32)
    got = ops.gather_distance(vec, q, ids)
    want = ref.gather_distance_ref(vec, q, ids)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5, f"gather_distance max abs err {err}"
    rows = torch.unique(ids).numel()
    b_ms, b_by = bound(rows * DIM * 4 + q.numel() * 4 + ids.numel() * 8,
                       2.0 * ids.numel() * DIM)
    # one call's rows (~50 MB) would fit the 50 MB L2: timed calls cycle
    # through 8 id sets so that every call finds its rows cold, as the
    # greedy descent does
    id_sets = itertools.cycle([ids] + [
        torch.randint(0, N_VECTORS, ids.shape, device=dev, generator=gen,
                      dtype=torch.int32) for _ in range(7)])
    out["gather_distance"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.gather_distance(vec, q, next(id_sets)),
                   48),
        plain_ms=time_ms(torch, lambda: ref.gather_distance_ref(
            vec, q, next(id_sets)), 24),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shapes=f"vectors {N_VECTORS}x{DIM} f32, q {N_QUERIES}x{DIM}, "
               f"ids {N_QUERIES}x{K_GATHER}")
    log("gather_distance " + json.dumps(out["gather_distance"]))

    # -- beam_search ----------------------------------------------------
    nbrs = torch.randint(0, N_VECTORS, (N_VECTORS, M2), device=dev,
                         generator=gen, dtype=torch.int32)
    pad = torch.rand(N_VECTORS, M2, device=dev, generator=gen) < 0.1
    nbrs = torch.where(pad, -1, nbrs).contiguous()           # -1 padding
    ep = torch.randint(0, N_VECTORS, (N_QUERIES,), device=dev, generator=gen,
                       dtype=torch.int32)
    ep_d = ref.gather_distance_ref(vec, q, ep[:, None])[:, 0].contiguous()
    # integer-valued rows with l2: exact arithmetic, so ids must match
    vint = torch.randint(-3, 4, (N_VECTORS, DIM), device=dev,
                         generator=gen).float()
    qint = torch.randint(-3, 4, (N_QUERIES, DIM), device=dev,
                         generator=gen).float()
    ep_di = ref.gather_distance_ref(vint, qint, ep[:, None],
                                    metric="l2")[:, 0].contiguous()
    beam = {}
    for t in (4, 1):
        ki, kd = ops.beam_search(vec, nbrs, q, ep, ep_d, ef=EF, expand_t=t)
        # the plain version's traversal says what work the search needs:
        # the distinct rows and neighbor lists all queries touch
        ri, rd, seen = ref.beam_search_ref(vec, nbrs, q, ep, ep_d, ef=EF,
                                           expand_t=t, return_visited=True)
        torch.cuda.synchronize()
        same = (ki == ri).all(dim=1)
        frac = same.float().mean().item()
        err = (kd[same] - rd[same]).abs().max().item()
        hit = (ki[:, :10, None] == ri[:, None, :10]).any(-1).float()
        recall = hit.mean().item()
        assert frac >= 0.99, f"beam_search T={t}: ids equal on {frac} of rows"
        assert err <= 1e-5, f"beam_search T={t}: dist err {err}"
        assert recall >= 0.999, f"beam_search T={t}: recall@10 {recall}"
        ki2, kd2 = ops.beam_search(vint, nbrs, qint, ep, ep_di, ef=EF,
                                   expand_t=t, metric="l2")
        ri2, rd2 = ref.beam_search_ref(vint, nbrs, qint, ep, ep_di, ef=EF,
                                       expand_t=t, metric="l2")
        torch.cuda.synchronize()
        assert bool((ki2 == ri2).all()), f"beam_search T={t} l2: ids differ"
        assert bool((kd2 == rd2).all()), f"beam_search T={t} l2: dists differ"
        n_rows = int(seen["rows"].sum().item())
        n_lists = int(seen["lists"].sum().item())
        b_ms, b_by = bound(n_rows * DIM * 4 + n_lists * M2 * 4
                           + q.numel() * 4 + N_QUERIES * 8
                           + N_QUERIES * EF * 8, 2.0 * seen["pairs"] * DIM)
        beam[t] = dict(
            max_abs_err=err, ids_equal_rows=frac, recall_at_10=recall,
            distinct_rows=n_rows, distinct_lists=n_lists,
            query_row_pairs=seen["pairs"],
            ms=time_ms(torch, lambda: ops.beam_search(
                vec, nbrs, q, ep, ep_d, ef=EF, expand_t=t), 10),
            plain_ms=time_ms(torch, lambda: ref.beam_search_ref(
                vec, nbrs, q, ep, ep_d, ef=EF, expand_t=t), 2, warmup=1),
            bound_ms=b_ms, bound_by=b_by)
        log(f"beam_search T={t} " + json.dumps(beam[t]))
    out["beam_search"] = dict(
        beam[4], library_ms=None, t1=beam[1],
        shapes=f"vectors {N_VECTORS}x{DIM} f32, neighbors0 {N_VECTORS}x{M2}"
               f" (10% -1), B {N_QUERIES}, ef {EF}, T 4 (t1: T 1)")
    del nbrs, pad, vec, q, ids, vint, qint

    # -- flash_decode ---------------------------------------------------
    import torch.nn.functional as F
    qd = torch.randn(DEC_B, DEC_H, DEC_DH, device=dev, generator=gen)
    kd = torch.randn(DEC_B, DEC_S, DEC_KVH, DEC_DH, device=dev, generator=gen)
    vd = torch.randn(DEC_B, DEC_S, DEC_KVH, DEC_DH, device=dev, generator=gen)
    cur = torch.tensor([1, 33, 1000, 4097, 5000, 6143, 8191, DEC_S],
                       dtype=torch.int32, device=dev)
    got = ops.flash_decode(qd, kd, vd, cur)
    want = ref.flash_decode_ref(qd, kd, vd, cur)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 2e-5, f"flash_decode max abs err {err}"
    mask = (torch.arange(DEC_S, device=dev)[None, :] < cur[:, None])
    mask = mask[:, None, None, :]                        # [B,1,1,S]

    def sdpa():
        return F.scaled_dot_product_attention(
            qd[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_err = (sdpa()[:, :, 0] - want).abs().max().item()
    live = int(cur.sum().item())
    b_ms, b_by = bound(live * DEC_KVH * DEC_DH * 4 * 2 + qd.numel() * 8
                       + DEC_B * 4, 4.0 * live * DEC_H * DEC_DH)
    out["flash_decode"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.flash_decode(qd, kd, vd, cur), 50),
        plain_ms=time_ms(torch, lambda: ref.flash_decode_ref(qd, kd, vd, cur),
                         20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, sdpa, 50), library_max_abs_err=lib_err,
        shapes=f"B {DEC_B}, H {DEC_H}, KVH {DEC_KVH}, Dh {DEC_DH}, "
               f"S {DEC_S} f32, cur_len {cur.tolist()}")
    log("flash_decode " + json.dumps(out["flash_decode"]))
    del qd, kd, vd
    torch.cuda.empty_cache()
    return out


def phase_serve(torch) -> dict:
    """The served path at full width, through launch.serve.run."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw as thnsw
    from repro_torch.data.corpus import BUILTIN_CORPUS
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = get_config("llama3-8b").model
    args = serve.parse_args(
        ["--rag", "--index", "hnsw", "--requests", "8", "--max-new", "16",
         "--slots", "4", "--max-len", "256", "--seed", "0",
         "--device", "cuda"])
    corpus = list(BUILTIN_CORPUS) + synthetic_corpus(SYNTHETIC_DOCS,
                                                     args.seed)
    log(f"serve: {cfg.name} at full width, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, fp32 random weights (seed "
        f"{args.seed}); {len(corpus)} documents")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dispatch.reset()
    res = serve.run(cfg, args, corpus=corpus)
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    wall = time.perf_counter() - t0
    eng, rag, reqs = res["engine"], res["rag"], res["reqs"]
    es, rs = eng.stats.as_dict(), rag.retriever.stats.as_dict()
    serve_out = dict(
        requests=len(reqs), tokens=res["tokens"], seconds=res["seconds"],
        req_per_s=len(reqs) / res["seconds"],
        tok_per_s=res["tokens"] / res["seconds"],
        setup_and_serve_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        engine=es, retrieval=rs, counters=counts,
        graph_max_level=rag.index.host_graph().max_level)
    log("serve " + json.dumps(serve_out))

    # every kernel of the path launched during the served run
    for c in dispatch.KERNEL_COUNTERS:
        assert counts.get(c, 0) > 0, f"{c} never launched on the served path"
    assert counts["kernel.flash_decode"] == cfg.n_layers * es["decode_ticks"]
    assert counts["kernel.beam_search"] == rs["searches"]
    assert all(r.done and len(r.out_tokens) == args.max_new for r in reqs)

    # retrieved keys == the same host graph searched on the CPU (plain
    # versions of the kernels)
    idx = rag.index
    cpu_g = thnsw.to_device_graph(idx.host_graph(), idx._deleted,
                                  device="cpu")
    qv = rag.encoder.encode([r.query for r in reqs])
    ids, _ = thnsw.search_graph(cpu_g, qv, k=3, ef=idx.ef_search,
                                beam_impl=idx.beam_impl)
    want = [[idx._keys[i] for i in row if i >= 0] for row in ids.tolist()]
    got = [[d.key for d in r.docs] for r in reqs]
    assert got == want, f"served keys {got} != CPU search {want}"
    log(f"served keys equal the CPU search: {got}")

    # flash_decode at the geometry the served run gave it (slots x max_len
    # cache, each slot at its own depth, so the same split + merge layout):
    # the kernel against its plain version on one layer's prefilled cache,
    # then one full-width decode_step, flash kernel vs the dense path
    model = eng.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (args.slots, args.max_len - 1),
                         device="cuda", generator=gen)
    lens = torch.tensor([1 + (args.max_len - 2) * i // (args.slots - 1)
                         for i in range(args.slots)], dtype=torch.int32,
                        device="cuda")
    _, cache = tf.prefill(model, toks, max_len=args.max_len, prompt_lens=lens)
    splits, chunk = ops._flash_splits(args.slots * cfg.n_kv_heads,
                                      args.max_len, torch.device("cuda"))
    qf = torch.randn(args.slots, cfg.n_heads, cfg.dh, device="cuda",
                     generator=gen)
    got = ops.flash_decode(qf, cache.k[0], cache.v[0], lens + 1)
    want = ref.flash_decode_ref(qf, cache.k[0], cache.v[0], lens + 1)
    torch.cuda.synchronize()
    ferr = (got - want).abs().max().item()
    assert ferr <= 2e-5, f"flash_decode at the served shape: err {ferr}"
    nxt = toks[torch.arange(args.slots, device="cuda"), lens.long() - 1]
    logits = {}
    for impl in ("flash", "dense"):
        c = tf.KVCache(cache.k.clone(), cache.v.clone(), cache.cur_len.clone())
        logits[impl], _ = tf.decode_step(model, nxt[:, None], c,
                                         attn_impl=impl)
    lf, ld = logits["flash"].float(), logits["dense"].float()
    assert lf.shape == (args.slots, 1, cfg.vocab)
    assert bool(torch.isfinite(lf).all())
    torch.testing.assert_close(lf, ld, rtol=1e-3, atol=1e-3)
    assert bool((lf.argmax(-1) == ld.argmax(-1)).all())
    serve_out["flash_at_served_shape"] = dict(
        cache=f"{args.slots} x {args.max_len}", live=(lens + 1).tolist(),
        splits=splits, chunk=chunk, kernel_vs_plain_max_abs_err=ferr,
        decode_step_flash_vs_dense_max_abs_diff=(lf - ld).abs().max().item())
    log("flash_decode at the served shape, kernel vs plain and decode_step "
        "flash vs dense (argmax equal) "
        + json.dumps(serve_out["flash_at_served_shape"]))
    serve_out["profile"] = profile_decode(torch, model, cfg, args)
    log("serve profile " + json.dumps(serve_out["profile"]))
    return serve_out


def profile_decode(torch, model, cfg, args) -> dict:
    """Where a served decode tick's time goes: wall time per prefill and
    per decode step at the served shapes (slots x max_len), and, from a
    ``torch.profiler`` trace of a few steps, the device-busy time, the
    kernel launches per step and the share of device time per op."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf

    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (args.slots, 128), device="cuda",
                         generator=gen)
    _, cache = tf.prefill(model, toks, max_len=args.max_len)
    tok = toks[:, -1:]

    def prefill():
        tf.prefill(model, toks, max_len=args.max_len)

    def step():
        c = tf.KVCache(cache.k, cache.v, cache.cur_len.clone())
        tf.decode_step(model, tok, c)

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {"prefill_wall_ms": wall_ms(prefill, 3),
           "decode_wall_ms": wall_ms(step, 10)}
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = {r.key: r.self_device_time_total / 1e3 for r in rows
           if r.self_device_time_total > 0 and r.key.startswith("aten::")}
    busy = sum(r.self_device_time_total for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(r.count for r in rows if r.key == "cudaLaunchKernel")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    out.update(
        decode_device_busy_ms=busy / steps,
        decode_launches=launches / steps,
        decode_top_ops_ms={k: v / steps for k, v in top},
        decode_flash_ms=sum(r.self_device_time_total for r in rows
                            if "flash_decode" in r.key) / 1e3 / steps,
        shapes=f"slots {args.slots}, prompt 128, max_len {args.max_len}")
    out["decode_idle_share"] = 1.0 - out["decode_device_busy_ms"] / max(
        out["decode_wall_ms"], 1e-9)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: needs PyTorch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    smi = phase_environment(torch)
    kern = phase_kernels(torch)
    serve_out = phase_serve(torch)
    launches = serve_out["counters"]
    sources = {
        "gather_distance": "src/repro/kernels/gather_distance.py:170",
        "beam_search": "src/repro/kernels/beam_search.py:269",
        "flash_decode": "src/repro/kernels/flash_decode.py:94",
    }
    line = []
    for name, rec in kern.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": sources[name],
                     "launches": launches[f"kernel.{name}"], **rec})
    log(f"total {time.perf_counter() - t0:.1f}s on {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
