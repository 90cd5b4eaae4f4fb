"""Time ``ops.beam_search`` on the card, whole call, with CUDA events.

MeMemo's 1M x 384 cosine rows (configs/mememo.py: seeded unit Gaussian
rows on the card) under each row codec (fp32; bf16; int8 + scales, encoded
by the port's codec), a random layer-0 graph [1M, 32] with 10 % -1
padding, 1,024 unit queries and random entry points. Cells:

- ``t4``, ``t1``: B 1024, ef 64, T 4 and T 1;
- ``served``: B 8, ef 64, T 4: one retrieval tick of the served RAG path
  (8 coalesced requests, M 16); the timed calls cycle over the 128
  disjoint sets of 8 of the 1,024 queries, so every call finds its rows
  cold;
- ``build``: int8 rows only, B 1024, ``neighbors0[:, :10]`` (M 5, the
  paper's build_1m), ef 20, T 4: the shape the bulk build launches 977
  times at 1M.

Each cell checks the kernel's ids against the plain version's (the
fraction of queries whose ids are all equal) and times the kernel: CUDA
events over back-to-back calls, and the device time a call with the
kernels a call from a ``torch.profiler`` trace. Beside it: the hop count
(``ref.beam_schedule``), the pair-bytes floor (the (query, row) distances
the search needs, from the plain version's traversal, x the row bytes /
3.35 TB/s) and the distinct-bytes bound (distinct rows and lists the
queries touch, q, ep and the output, once each), and, where the checkout
has it, the block plan (threads, ring rows, shared bytes, blocks an SM).
Prints one JSON line a cell. ``--root`` times the port of another
checkout (for example the parent commit unpacked by ``git archive``), so
two versions compare within one run:

    python scripts/time_beam_search.py --tag change
    python scripts/time_beam_search.py --root build/scratch/parent --tag parent
"""
import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
N, D, M2, B, EF = 1_000_000, 384, 32, 1024, 64
SERVED_B = 8
BUILD_M2, BUILD_EF = 10, 20
CELLS = ("t4", "t1", "served", "build")


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


def device_ms(fn, reps: int) -> tuple[float, float]:
    """-> (device ms a call, kernels a call) from a ``torch.profiler``
    trace of ``reps`` calls: every kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(r.self_device_time_total for r in rows) / 1e3 / reps,
            sum(r.count for r in rows) / reps)


def encode(x, codec):
    from repro_torch.core.codec import device_rows, get_codec

    if codec == "fp32":
        return x, None
    enc, scales = get_codec(codec).encode(x.cpu().numpy())
    return (device_rows(enc, x.device),
            None if scales is None else torch.from_numpy(
                np.ascontiguousarray(scales)).to(x.device))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--codecs", default="fp32,bf16,int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.kernels import build, ops, ref

    # only this kernel is built (a checkout builds every source at first
    # use otherwise)
    build.SOURCES = {"beam_search": build.SOURCES["beam_search"]}
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
    nbrs = torch.randint(0, N, (N, M2), device=dev, generator=g,
                         dtype=torch.int32)
    pad = torch.rand(N, M2, device=dev, generator=g) < 0.1
    nbrs = torch.where(pad, -1, nbrs).contiguous()
    del pad
    ep = torch.randint(0, N, (B,), device=dev, generator=g,
                       dtype=torch.int32)
    nbrs_build = nbrs[:, :BUILD_M2].contiguous()
    cells = args.cells.split(",")
    for codec in args.codecs.split(","):
        rows, scales = encode(vec, codec)
        ep_d = ref.gather_distance_ref(rows, q, ep[:, None],
                                       scales=scales)[:, 0].contiguous()
        row_bytes = D * rows.element_size() + (0 if scales is None else 4)
        for cell in cells:
            if cell == "build" and codec != "int8":
                continue
            graph, ef, t = {"t4": (nbrs, EF, 4), "t1": (nbrs, EF, 1),
                            "served": (nbrs, EF, 4),
                            "build": (nbrs_build, BUILD_EF, 4)}[cell]
            m2 = graph.shape[1]
            kw = dict(ef=ef, expand_t=t, scales=scales)
            want_i, _ = ref.beam_search_ref(rows, graph, q, ep, ep_d, **kw)
            b = SERVED_B if cell == "served" else B
            sets = [(q[i:i + b], ep[i:i + b], ep_d[i:i + b])
                    for i in range(0, B, b)]
            got = torch.cat([ops.beam_search(rows, graph, qs, es, eds, **kw)[0]
                             for qs, es, eds in sets])
            torch.cuda.synchronize()
            same = (got == want_i).all(dim=1).float().mean().item()
            # the work one call needs: the plain version's traversal of
            # its queries (the first set)
            seen = ref.beam_search_ref(rows, graph, *sets[0], **kw,
                                       return_visited=True)[2]
            cyc = itertools.cycle(sets)

            def call():
                qs, es, eds = next(cyc)
                return ops.beam_search(rows, graph, qs, es, eds, **kw)

            reps = max(len(sets), 10 if t == 4 else 5)
            dms, kernels = device_ms(call, min(reps, 32))
            plan = None
            if hasattr(ops, "beam_search_info"):
                plan = ops.beam_search_info(b, D, ops.CODEC_OF[rows.dtype],
                                            m2, ef, min(t, ef))
            pairs = seen["pairs"]
            nbytes = (int(seen["rows"].sum().item()) * row_bytes
                      + int(seen["lists"].sum().item()) * m2 * 4
                      + b * D * 4 + b * 8 + b * ef * 8)
            print(json.dumps({
                "tag": args.tag, "cell": cell, "codec": codec, "B": b,
                "m2": m2, "ef": ef, "T": t,
                "hops": ref.beam_schedule(ef, t, None)[2],
                "ids_equal_frac": same, "ms": events_ms(call, reps),
                "device_ms": dms, "kernels_a_call": kernels,
                "query_row_pairs": pairs,
                "pair_floor_ms": pairs * row_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "plan": plan, "card": card}),
                flush=True)
        del rows, scales
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
