"""The readings a cell's correctness limits are set from, on the card at
the cell's own size: the program's own readings, the control (the plain
reference put in the program's place, one precision below the
configuration's) and each planted fault, on the same seeds.

    python3 chipbench/control.py --workload <name> --seeds 1,2,3

For each seed it builds the cell's index once and judges, on as many pool
batches as a run judges, the answers of: the program; the control, an
exact search whose products read TF32 operands; and the program with each
fault of ``FAULTS`` planted underneath ``query_batch``. One JSON line a
seed. The benchmark's own runs never run this."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench.lib import env, spec  # noqa: E402


@contextlib.contextmanager
def _descent_skipped():
    """The beam enters layer 0 at the top entry point."""
    from repro_torch.kernels import ops
    orig = ops.greedy_descent
    ops.greedy_descent = lambda vectors, upper, q, ep, ep_dist, **kw: (
        ep, ep_dist)
    try:
        yield
    finally:
        ops.greedy_descent = orig


@contextlib.contextmanager
def _beam_one_hop():
    """The beam stops after its first hop."""
    from repro_torch.kernels import ops
    orig = ops.beam_search

    def one_hop(*a, **kw):
        return orig(*a, **(kw | {"max_iters": kw.get("expand_t", 4)}))
    ops.beam_search = one_hop
    try:
        yield
    finally:
        ops.beam_search = orig


# faults of a degraded search, planted underneath ``query_batch``; each
# yields the ef its calls pass
FAULTS = {
    "ef_16": lambda: contextlib.nullcontext(16),
    "descent_skipped": _descent_skipped,
    "beam_one_hop": _beam_one_hop,
}


def search_readings(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{variant: checks} for the program, the control and each fault."""
    import numpy as np
    from chipbench.drivers import hnsw_search
    from chipbench.lib import reference
    rows, pool = hnsw_search.make_inputs(cfg, mix, seed, device)
    idx = hnsw_search.build_index(cfg, rows.cpu().numpy(), device)
    graph = hnsw_search.graph_of(idx, device)
    k, ef = mix["k"], mix["ef"]
    picks = np.random.default_rng(seed).choice(
        len(pool), min(mix["check_batches"], len(pool)),
        replace=False).tolist()
    pool_host = pool.cpu().numpy()

    def program(ef_call):
        return [(b, *idx.query_batch(pool_host[b], k=k, ef=ef_call))
                for b in picks]
    unit = reference.unit_rows(rows)
    control = []
    for b in picks:
        ids, d = reference.exact_topk(unit, pool[b], k, precision="tf32")
        control.append((b, [[f"r{i}" for i in row] for row in ids.tolist()],
                        d.cpu().numpy()))
    answers = {"program": program(ef), "control": control}
    for name, fault in FAULTS.items():
        with fault() as ef_fault:
            answers[name] = program(ef_fault or ef)
    out = {}
    for name, ans in answers.items():
        checks, info = hnsw_search.judge(rows, pool, ans, k, ef,
                                         cfg["limits"], graph)
        out[name] = {c: v["value"] for c, v in checks.items()} | {
            "recall_at_k": info["recall_at_k"],
            "correct": all(v["value"] <= v["limit"]
                           for v in checks.values())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    env.set_cache_dirs(ROOT)
    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"])
    import torch
    env.require_cards(torch, cell["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = search_readings(cfg, mix, seed, "cuda")
        print(json.dumps({"seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
