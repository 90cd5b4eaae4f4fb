"""Time ``ops.gather_distance`` (the hop kernel) and the upper-layer greedy
descent on the card.

MeMemo's 1M x 384 cosine rows (configs/mememo.py: seeded unit Gaussian
rows on the card) under each row codec (fp32; bf16; int8 + scales, encoded
by the port's codec) and 1,024 unit queries. Cells:

- hop kernel, ``hop_b1024_k32``, ``hop_b8_k16`` (a served hop: 8
  coalesced requests, M 16) and ``hop_b1024_k5`` (a bulk-build hop: M 5):
  random ids, the timed calls cycling over enough id sets that every call
  finds its rows cold (their rows pass twice the 50 MB L2); the device
  time a launch (``torch.profiler``) and CUDA events over back-to-back
  calls (the wrapper's host time sets those at the small cells), the
  plain version's time, the distinct-bytes
  bound, the distances' max error against the plain version;
- descent, ``descent_served`` (B 8, a random upper table [4, 1M, 16], the
  calls cycling over the 128 sets of 8 queries) and ``descent_build``
  (B 1024, [8, 1M, 5]): every query enters at row 0, as a search does.
  The checkout's descent: ``ops.greedy_descent`` where it has one (one
  launch), else the per-hop loop of ``core/hnsw.py:_greedy_layer`` (a
  hop kernel launch, ~10 small PyTorch ops and a host read of the loop
  condition a hop). Device ms a call (the one launch's, or the sum of
  the loop's kernels) and kernels traced a call from a
  ``torch.profiler`` trace, wall ms a call (host clock, synchronised),
  and wall ms and host syncs of a whole search (``hnsw.search_core`` on
  a device graph of the same rows and table, with a random layer-0 graph
  [1M, 2M] and ef 64 / 20); ep equal to the plain version's on the
  fraction of queries printed; the hops the plain version's traversal
  needs (the most a query takes, and the lock-step loop's) and the
  bound, the distinct lists and rows it reads over 3.35 TB/s.

Prints one JSON line a cell. ``--root`` times the port of another
checkout (for example the parent commit unpacked by ``git archive``), so
two versions compare within one run:

    python scripts/time_gather_distance.py --tag change
    python scripts/time_gather_distance.py --root build/scratch/parent --tag parent
"""
import argparse
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
N, D, B = 1_000_000, 384, 1024
HOP_CELLS = {"hop_b1024_k32": (1024, 32), "hop_b8_k16": (8, 16),
             "hop_b1024_k5": (1024, 5)}
# descent cells: (B, M, ef of the whole search); L = floor(ln N / ln M),
# the top level a graph of N rows at that M reaches
DESCENT_CELLS = {"descent_served": (8, 16, 64), "descent_build": (1024, 5, 20)}


def events_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps: int) -> tuple[float, float, float]:
    """-> (device ms a call, kernels a call, device ms a traced kernel)
    from a ``torch.profiler`` trace of ``reps`` calls: every kernel on the
    card. The profiler drops some launches, so for a call of one launch
    the last is its device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(r.self_device_time_total for r in rows) / 1e3
    count = sum(r.count for r in rows)
    return total / reps, count / reps, total / max(count, 1)


def encode(x, codec):
    from repro_torch.core.codec import device_rows, get_codec

    if codec == "fp32":
        return x, None
    enc, scales = get_codec(codec).encode(x.cpu().numpy())
    return (device_rows(enc, x.device),
            None if scales is None else torch.from_numpy(
                np.ascontiguousarray(scales)).to(x.device))


def hop_cell(ops, ref, rows, scales, q, gen, b, k, row_bytes) -> dict:
    n_sets = max(8, math.ceil(2 * L2_BYTES / (b * k * row_bytes)))
    ids = torch.randint(0, N, (n_sets * b, k), device=q.device,
                        generator=gen, dtype=torch.int32)
    sets = [(q[i * b % B:i * b % B + b], ids[i * b:(i + 1) * b])
            for i in range(n_sets)]
    qs, i0 = sets[0]
    got = ops.gather_distance(rows, qs, i0, scales=scales)
    want = ref.gather_distance_ref(rows, qs, i0, scales=scales)
    err = (got - want).abs().max().item()
    per_elem = 2.0 if scales is None else 3.0
    nbytes = (torch.unique(i0).numel() * row_bytes + b * D * 4
              + i0.numel() * 8)
    cyc = itertools.cycle(sets)

    def kernel():
        qq, ii = next(cyc)
        return ops.gather_distance(rows, qq, ii, scales=scales)

    def plain():
        qq, ii = next(cyc)
        return ref.gather_distance_ref(rows, qq, ii, scales=scales)

    plan = ops._gather_plan(b, k, 132) if hasattr(ops, "_gather_plan") \
        else None
    _, kernels, dev = device_ms(kernel, min(n_sets, 64))
    return dict(B=b, K=k, id_sets=n_sets, max_abs_err=err,
                device_ms=dev, kernels_traced_a_call=kernels,
                ms=events_ms(kernel, max(48, min(n_sets, 512))),
                plain_ms=events_ms(plain, 8 if b > 8 else 48),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             per_elem * b * k * D / 67e12) * 1e3,
                bound_by="bytes", plan=plan)


def descent_cell(ops, ref, thnsw, dispatch, rows, scales, q, gen, b, m, ef,
                 row_bytes) -> dict:
    layers = int(math.log(N) / math.log(m))
    up = torch.randint(0, N, (layers, N, m), device=q.device, generator=gen,
                       dtype=torch.int32)
    pad = torch.rand(layers, N, m, device=q.device, generator=gen) < 0.1
    up = torch.where(pad, -1, up).contiguous()
    del pad
    nbrs = torch.randint(0, N, (N, 2 * m), device=q.device, generator=gen,
                         dtype=torch.int32)
    g = thnsw.DeviceGraph(
        vectors=rows, neighbors0=nbrs, upper=up,
        levels=torch.zeros(N, dtype=torch.int32, device=q.device), entry=0,
        deleted=torch.zeros(N, dtype=torch.bool, device=q.device),
        max_level=layers, metric="cosine", scales=scales)
    ep = torch.zeros(B, dtype=torch.int32, device=q.device)
    ep_d = ref.gather_distance_ref(rows, q, ep[:, None],
                                   scales=scales)[:, 0].contiguous()
    sets = [slice(i, i + b) for i in range(0, B, b)]
    one = hasattr(ops, "greedy_descent")

    def descend(s):
        if one:
            return ops.greedy_descent(rows, up, q[s], ep[s], ep_d[s],
                                      max_level=layers, scales=scales)
        e, d = ep[s], ep_d[s]
        for layer in range(layers, 0, -1):
            e, d = thnsw._greedy_layer(g, q[s], e, d, layer)
        return e, d

    got = [descend(s) for s in sets]
    ge = torch.cat([e for e, _ in got])
    gd = torch.cat([d for _, d in got])
    stats = {}
    we, wd = ref.greedy_descent_ref(rows, up, q, ep, ep_d, max_level=layers,
                                    scales=scales, stats=stats) \
        if hasattr(ref, "greedy_descent_ref") else (ge, gd)
    same = ge == we
    # the work of the first call's queries
    first = {}
    if hasattr(ref, "greedy_descent_ref"):
        ref.greedy_descent_ref(rows, up, q[sets[0]], ep[sets[0]],
                               ep_d[sets[0]], max_level=layers,
                               scales=scales, stats=first)
    cyc = itertools.cycle(sets)

    def call():
        return descend(next(cyc))

    def search():
        return thnsw.search_core(g, q[next(cyc)], ef, ef)

    dms, kernels, per_kernel = device_ms(call, max(8, min(len(sets), 32)))
    search()
    torch.cuda.synchronize()
    dispatch.reset()
    search()
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    rec = dict(B=b, M=m, L=layers, ef=ef,
               ep_equal_plain_frac=same.float().mean().item(),
               max_abs_err=(gd[same] - wd[same]).abs().max().item(),
               device_ms=per_kernel if one else dms,
               kernels_traced_a_call=kernels,
               wall_ms=wall_ms(call, max(len(sets), 8)),
               search_wall_ms=wall_ms(search, max(len(sets), 8)),
               search_host_syncs=counts.get("hnsw.host_syncs", 0),
               search_gather_launches=counts.get("kernel.gather_distance",
                                                 0),
               one_launch=one)
    if first:
        nbytes = (first["lists"] * m * 4
                  + int(first["rows"].sum().item()) * row_bytes
                  + b * (D * 4 + 16))
        rec.update(hops_max=int(first["hops"].max().item()),
                   hops_total=int(first["hops"].sum().item()),
                   lockstep_hops=first["lockstep_hops"],
                   lists=first["lists"],
                   rows=int(first["rows"].sum().item()),
                   pairs=first["pairs"],
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if one:
        # bit for bit: the one-launch descent == the per-hop loop through
        # the hop kernel
        le, ld = ref.greedy_descent_ref(rows, up, q, ep, ep_d,
                                        max_level=layers, scales=scales,
                                        gather=ops.gather_distance)
        rec["equals_per_hop_loop"] = bool(torch.equal(le, ge)
                                          and torch.equal(ld, gd))
        rec["plan"] = ops._descent_plan(D, ops.CODEC_OF[rows.dtype], m, 1)
    del up, nbrs, g
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells",
                    default=",".join([*HOP_CELLS, *DESCENT_CELLS]))
    ap.add_argument("--codecs", default="fp32,bf16,int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw as thnsw
    from repro_torch.kernels import build, ops, ref

    # only the search's kernels are built
    build.SOURCES = {k: build.SOURCES[k]
                     for k in ("gather_distance", "beam_search")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    vec = unit(torch.randn(N, D, device=dev, generator=g))
    q = unit(torch.randn(B, D, device=dev, generator=g))
    cells = args.cells.split(",")
    for codec in args.codecs.split(","):
        rows, scales = encode(vec, codec)
        row_bytes = D * rows.element_size() + (0 if scales is None else 4)
        for cell in cells:
            gen = torch.Generator(device=dev).manual_seed(1)
            if cell in HOP_CELLS:
                rec = hop_cell(ops, ref, rows, scales, q, gen,
                               *HOP_CELLS[cell], row_bytes)
            else:
                rec = descent_cell(ops, ref, thnsw, dispatch, rows, scales,
                                   q, gen, *DESCENT_CELLS[cell], row_bytes)
            print(json.dumps({"tag": args.tag, "cell": cell, "codec": codec,
                              **rec, "card": card}), flush=True)
            torch.cuda.empty_cache()
        del rows, scales
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
