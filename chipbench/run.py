"""Run one cell of the benchmark once and print its result line.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
driver are found by name (``chipbench/lib/spec.py``); the driver builds
the system under test from the seed, warms every shape, measures for
``--seconds``, and checks what the timed path produced against the plain
reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error. Without a CUDA card,
or with fewer than the cell asks for, it exits non-zero and prints no
result."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench.lib import env, spec  # noqa: E402


def result(bench: dict, cell: str, rec: dict, trace: bool, kind: str,
           count: int) -> dict:
    """The result line of a driver's record: the cell's metrics by their
    readers, the device, the breakdown of a traced run, and last the
    checks."""
    metrics = {}
    for m in spec.metrics_for(bench, cell, trace):
        v = spec.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = rec.get("trace") or {}
        device.update(busy_s=tr.get("busy_s"), window_s=tr.get("window_s"))
        out["breakdown"] = {"device_ops": tr.get("device_ops", []),
                            "idle_gaps": tr.get("idle_gaps", [])}
    out["checks"] = rec["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.set_cache_dirs(ROOT)
    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"])

    import torch
    env.require_cards(torch, cell["chips"])
    drv = spec.driver(mix["driver"])
    smi = env.SmiSampler()
    rec = drv.run(cfg, mix, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t0=T0, device="cuda", smi=smi)

    loaded = env.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    out = result(bench, args.workload, rec, bool(args.trace),
                 torch.cuda.get_device_name(0), cell["chips"])
    print(json.dumps({"card": rec.get("smi", {}),
                      "info": rec.get("info", {}),
                      "window": {k: rec.get(k) for k in
                                 ("window_s", "calls", "cpu_s",
                                  "card_busy")}}), flush=True)
    for name, c in rec["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
