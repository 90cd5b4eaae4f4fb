"""Where the host time of a sharded search goes, on the card's machine.

Builds MeMemo's 1M x 384 int8 rows (``chip_smoke.py``'s phase 9 draw,
seed 29) into a flat and an IVF index at one shard and at ``--shards``
shards, in two layouts one after the other in one process:

- ``one card``: every shard on cuda:0 (``REPRO_TORCH_SHARD_DEVICES``);
- ``one a card``: shard s on cuda:s, when the machine has ``--shards``
  cards (skipped otherwise).

For each index and batch (B 8 and 128) it warms the search, then times
``--reps`` searches one by one (host clock around ``query_batch``, which
returns host arrays, so each call ends in a read of the merged result)
and prints their median, min, max and mean beside the mean of the first
three. A ``torch.profiler`` trace (CPU and CUDA) of ``--trace-reps``
searches at B 8 gives the host ops that hold the most time a search;
the whole table goes to ``<--out>/trace_sharded_<layout>_<index>.txt``.
It also prints which card pairs have peer access and the host time of
one small [8, 10] cross-card copy. Only ``gather_distance`` and
``distance_topk`` are built. Prints the card's name and power limit,
then one JSON line a layout:

    python scripts/trace_sharded.py --shards 4 [--out DIR]
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def search_walls(torch, idx, qs, b: int, reps: int) -> dict:
    """Host ms of ``reps`` searches of B ``b``, each timed on its own,
    after five warm ones."""
    for _ in range(5):
        idx.query_batch(qs[:b], k=10)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        idx.query_batch(qs[:b], k=10)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "mean": statistics.fmean(ms), "first3_mean": statistics.fmean(
                ms[:3]), "reps": reps}


def host_ops(torch, idx, qs, reps: int, path: Path) -> list[dict]:
    """The ops with the most host (self CPU) time over ``reps`` traced
    searches at B 8, ms a search; the whole table to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    idx.query_batch(qs[:8], k=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            idx.query_batch(qs[:8], k=10)
    table = prof.key_averages()
    path.write_text(table.table(sort_by="self_cpu_time_total",
                                row_limit=60))
    rows = sorted(table, key=lambda r: -r.self_cpu_time_total)[:12]
    return [{"op": r.key, "calls_a_search": r.count / reps,
             "self_cpu_ms_a_search": r.self_cpu_time_total / 1e3 / reps}
            for r in rows]


def copy_us(torch, src: int, dst: int, reps: int = 200) -> float:
    """Host µs of one non-blocking [8, 10] f32 copy from cuda:src to
    cuda:dst (the size of a shard's merge list), ended by a read."""
    x = torch.randn(8, 10, device=f"cuda:{src}")
    dev = torch.device("cuda", dst)
    for _ in range(10):
        x.to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = x.to(dev, non_blocking=True)
    y.cpu()
    return (time.perf_counter() - t0) * 1e6 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--trace-reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "scratch"),
                    help="directory for the profiler tables")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("trace_sharded: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.mememo import CONFIG
    from repro_torch.core.index import make_index
    from repro_torch.kernels import build

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    build.SOURCES = {k: build.SOURCES[k]
                     for k in ("gather_distance", "distance_topk")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    n_dev = torch.cuda.device_count()
    print(json.dumps({
        "cards": n_dev,
        "peer_access": {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
                        for a in range(n_dev) for b in range(n_dev)
                        if a != b},
        "copy_us": {f"{a}->{b}": copy_us(torch, a, b)
                    for a, b in ((0, 0), (1, 0), (0, 1))
                    if max(a, b) < n_dev}}), flush=True)

    cfg = CONFIG.model
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn(cs.BULK_ROWS, cfg.dim, device="cuda",
                    generator=gen).cpu().numpy()
    qs = torch.randn(max(cs.SHARD_BATCHES), cfg.dim, device="cuda",
                     generator=gen).cpu().numpy()
    keys = [f"v{i}" for i in range(cs.BULK_ROWS)]
    common = dict(dim=cfg.dim, metric=cfg.metric, dtype="int8",
                  device="cuda")
    ivf_cfg = dict(common, nlist=cfg.nlist, nprobe=cfg.nprobe)
    ivf1 = make_index("ivf", **ivf_cfg)
    ivf1.bulk_insert(keys, x)
    ivf1.query_batch(qs[:1], k=10)                    # trains
    state = ivf1.state_dict()
    flat1 = make_index("flat", **common)
    flat1.restore_state({k: v for k, v in state[0].items()
                         if k != "centroids"},
                        {k: v for k, v in state[1].items()
                         if k not in ("has_centroids", "nlist")})
    ones = {"flat": flat1, "ivf": ivf1}
    layouts = {"one card": ",".join(["cuda:0"] * args.shards)}
    if n_dev >= args.shards:
        layouts["one a card"] = None
    for name, devices in layouts.items():
        old = cs.shard_env(devices)
        try:
            rec = {"layout": name, "card": card, "cards": n_dev}
            for kind, one in ones.items():
                four = make_index(kind, n_shards=args.shards,
                                  **(ivf_cfg if kind == "ivf" else common))
                four.restore_state(*one.state_dict())
                got = four.query_batch(qs[:cs.SHARD_SAMPLE], k=10)[0]
                assert got == one.query_batch(qs[:cs.SHARD_SAMPLE],
                                              k=10)[0], (name, kind)
                rec[kind] = {
                    "keys_equal_one_shard": True,
                    "devices": [str(d) for d in four._rows.devices],
                    "wall_ms": {
                        f"B{b}": {"1 shard": search_walls(torch, one, qs, b,
                                                          args.reps),
                                  f"{args.shards} shards": search_walls(
                                      torch, four, qs, b, args.reps)}
                        for b in cs.SHARD_BATCHES},
                    "host_ops_B8": host_ops(
                        torch, four, qs, args.trace_reps,
                        out / f"trace_sharded_{name.replace(' ', '_')}_"
                              f"{kind}.txt")}
                if kind == "flat":
                    rec[kind]["slack"] = four._rows.pack().slack
                del four
                cs.release(torch)
            print(json.dumps(rec), flush=True)
        finally:
            cs.shard_env(old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
