"""Time ``ops.flat_topk`` on the card, whole call, with CUDA events.

Random unit rows (1M x D, seeded on the card) per codec (fp32, bf16, int8
with per-row scales), k 10, cosine, B queries; each cell first checks its
ids against the plain version. Prints one JSON line a cell. ``--root``
times the port of another checkout (for example the parent commit
unpacked by ``git archive``), so two versions compare within one run:

    python scripts/time_flat_topk.py --tag change
    python scripts/time_flat_topk.py --root ../parent --tag parent
"""
import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--dims", default="384")
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(0)
    for d in map(int, args.dims.split(",")):
        x = torch.randn(args.rows, d, device="cuda", generator=g)
        x /= x.norm(dim=1, keepdim=True)
        s8 = (x.abs().amax(dim=1) / 127).contiguous()
        dbs = {"fp32": (x, None), "bf16": (x.to(torch.bfloat16), None),
               "int8": (torch.round(x / s8[:, None]).to(torch.int8), s8)}
        for codec, (db, sc) in dbs.items():
            for b in map(int, args.batches.split(",")):
                q = torch.randn(b, d, device="cuda", generator=g)
                q /= q.norm(dim=1, keepdim=True)
                _, ki = ops.flat_topk(db, q, args.k, scales=sc)
                _, ri = ref.distance_topk_ref(db, q, args.k, scales=sc)
                same = float((ki == ri).all(dim=1).float().mean())
                for _ in range(10):
                    ops.flat_topk(db, q, args.k, scales=sc)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.iters):
                    ops.flat_topk(db, q, args.k, scales=sc)
                e1.record()
                torch.cuda.synchronize()
                print(json.dumps({"tag": args.tag, "D": d, "codec": codec,
                                  "B": b, "k": args.k, "ids_equal_rows": same,
                                  "ms": e0.elapsed_time(e1) / args.iters}),
                      flush=True)
        del x, dbs


if __name__ == "__main__":
    main()
