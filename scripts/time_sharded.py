"""Time the sharded fan-out (``n_shards > 1``) on the card's machine.

Runs chip_smoke's phase 9 cells at MeMemo's 1M x 384 int8 rows
(``chip_smoke.py:sharded_1m``: flat and IVF at ``--shards`` shards against
one shard of the same rows; keys held equal on a sample; the wall of a
search at B 8 and 128; each shard's ``distance_topk`` and fine hop launch
with its bound; the tree merge) in two layouts, one after the other in
one process so that they compare on one machine:

- ``one card``: every shard on cuda:0 (``REPRO_TORCH_SHARD_DEVICES``),
  their launches one after another;
- ``one a card``: shard s on cuda:s, when the machine has ``--shards``
  cards (skipped otherwise).

Prints the card's name and power limit, then one JSON line a layout:

    python scripts/time_sharded.py --shards 4
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("time_sharded: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.phase_environment(torch)        # builds the kernels
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn(cs.BULK_ROWS, cs.DIM, device="cuda",
                    generator=gen).cpu().numpy()
    qs = torch.randn(max(cs.SHARD_BATCHES), cs.DIM, device="cuda",
                     generator=gen).cpu().numpy()
    keys = [f"v{i}" for i in range(cs.BULK_ROWS)]
    layouts = {"one card": ",".join(["cuda:0"] * args.shards)}
    if torch.cuda.device_count() >= args.shards:
        layouts["one a card"] = None
    for name, devices in layouts.items():
        old = cs.shard_env(devices)
        try:
            t0 = time.perf_counter()
            out = cs.sharded_1m(torch, x, qs, keys, args.shards)
            out.pop("arrays")
            print(json.dumps({"layout": name, "card": card,
                              "cards": torch.cuda.device_count(),
                              "seconds": time.perf_counter() - t0, **out}),
                  flush=True)
        finally:
            cs.shard_env(old)
            cs.release(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
