"""Time ``ops.embedding_bag`` on the card.

MIND's published table (src/repro/configs/mind.py: 1M items x 64, seeded
Gaussian rows on the card, fp32 and bf16) with bags of L 50 at the
recsys serve batches of configs/base.py RECSYS_SHAPES: B 512
(serve_p99) and 262,144 (serve_bulk); ``sum`` and ``mean``, with a
behaviour mask as weights (each bag's first n_b members, n_b uniform in
[1, L], the tail at weight 0) and without weights. Ids are uniform. At
B 512 the timed calls cycle over 8 bag sets, so the rows they read pass
the 50 MB L2 rather than stay in it.

Each cell: the device time a launch (``torch.profiler``), the call time
(CUDA events over back-to-back calls, the wrapper's host time
included), the max error against the plain version (held within rtol
and atol 1e-5), the bound (the distinct rows of weighted members, the
ids, weights and output over 3.35 TB/s) and the time to read every
member's row at 3.35 TB/s (the reference multiplies every member's row
by its weight, so every row is read). Prints one JSON line a cell with
the card's name and power limit. ``--root`` times the port of another
checkout (for example the parent commit unpacked by ``git archive``),
so two versions compare within one run:

    python scripts/time_embedding_bag.py --tag change
    python scripts/time_embedding_bag.py --root build/scratch/parent --tag parent
"""
import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
ROWS, DIM, LEN = 1_000_000, 64, 50
BATCHES = (512, 262_144)


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
    """-> (device ms a traced launch of the kernel, launches traced a
    call) from a ``torch.profiler`` trace of ``reps`` calls; any other
    kernel on the card raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for r in prof.key_averages():
        if r.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "embedding_bag_kernel" not in r.key:
            raise RuntimeError(f"another kernel in the trace: {r.key}")
        total += r.self_device_time_total
        count += r.count
    return total / 1e3 / max(count, 1), count / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.kernels import build, ops, ref

    build.SOURCES = {"embedding_bag": build.SOURCES["embedding_bag"]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    table32 = torch.randn(ROWS, DIM, device=dev, generator=gen)
    pos = torch.arange(LEN, device=dev)
    for b in map(int, args.batches.split(",")):
        sets = []
        for _ in range(8 if b <= 512 else 1):
            ids = torch.randint(0, ROWS, (b, LEN), device=dev, generator=gen,
                                dtype=torch.int32)
            n_b = torch.randint(1, LEN + 1, (b, 1), device=dev,
                                generator=gen)
            sets.append((ids, (pos[None, :] < n_b).float().contiguous()))
        ids, w = sets[0]
        live = w > 0
        work = {"mask": (torch.unique(ids[live]).numel(), 8),
                "none": (torch.unique(ids).numel(), 4)}
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            for wk in ("mask", "none"):
                for combine in ("sum", "mean"):
                    wi = w if wk == "mask" else None
                    got = ops.embedding_bag(table, ids, wi, combine=combine)
                    want = ref.embedding_bag_ref(table, ids, wi,
                                                 combine=combine)
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
                    cyc = itertools.cycle(sets)

                    def call():
                        i, ww = next(cyc)
                        return ops.embedding_bag(
                            table, i, ww if wk == "mask" else None,
                            combine=combine)

                    n_rows, id_bytes = work[wk]
                    bound = (n_rows * DIM * table.element_size()
                             + ids.numel() * id_bytes + b * DIM * 4)
                    dms, traced = device_ms(call, 32 if b <= 512 else 8)
                    print(json.dumps({
                        "tag": args.tag, "B": b, "L": LEN,
                        "dtype": str(dtype).split(".")[-1],
                        "combine": combine, "weights": wk,
                        "device_ms": dms, "launches_traced_a_call": traced,
                        "ms": events_ms(call, 50 if b <= 512 else 20),
                        "max_abs_err": (got - want).abs().max().item(),
                        "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                        "every_row_ms": ids.numel() * DIM
                        * table.element_size() / HBM_BYTES_PER_S * 1e3,
                        "splits": (ops._bag_plan(b, LEN, DIM, sms)
                                   if hasattr(ops, "_bag_plan") else 1),
                        "card": card}), flush=True)
            del table
        del sets, ids, w, live
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
