"""Time ``ops.flash_decode`` on the card, whole call, with CUDA events.

Three cells of the llama3-8b decode geometry (H 32, KVH 8, Dh 128, fp32,
seeded random q, K and V on the card):

- ``ragged``: B 8, S 8192, cur_len [1, 33, 1000, 4097, 5000, 6143, 8191,
  8192];
- ``full``: B 8, S 8192, every row at 8192;
- ``served``: the served cache, 4 slots x max_len 256 at live lengths
  [2, 86, 171, 256], one cache per layer (32), the timed calls cycling
  through them as a decode tick does, so that each call finds its cache
  out of L2.

Each cell checks the kernel against the plain version (max abs error)
and times the kernel (CUDA events over back-to-back calls, and the device
time a call with the kernels a call from a ``torch.profiler`` trace), the
plain version and ``torch.nn.functional.scaled_dot_product_attention``
(the library yardstick), beside the bound: live K and V bytes (+ q, out,
cur_len) over 3.35 TB/s. Prints one JSON line a cell. ``--root`` times the port of
another checkout (for example the parent commit unpacked by ``git
archive``), so two versions compare within one run:

    python scripts/time_flash_decode.py --tag change
    python scripts/time_flash_decode.py --root build/scratch/parent --tag parent
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
H, KVH, DH = 32, 8, 128
CELLS = {
    "ragged": (8192, [1, 33, 1000, 4097, 5000, 6143, 8191, 8192], 1),
    "full": (8192, [8192] * 8, 1),
    "served": (256, [2, 86, 171, 256], 32),
}


def events_ms(fn, reps: int) -> float:
    for _ in range(3):
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
    trace of ``reps`` calls: every kernel on the card, the wrapper's own
    and any other."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--reps", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.kernels import ops, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in args.cells.split(","):
        s, lens, layers = CELLS[name]
        b = len(lens)
        cur = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, H, DH, device="cuda", generator=g)
        kv = [(torch.randn(b, s, KVH, DH, device="cuda", generator=g),
               torch.randn(b, s, KVH, DH, device="cuda", generator=g))
              for _ in range(layers)]
        err = max((ops.flash_decode(q, k, v, cur)
                   - ref.flash_decode_ref(q, k, v, cur)).abs().max().item()
                  for k, v in kv)
        mask = (torch.arange(s, device="cuda")[None, :]
                < cur[:, None])[:, None, None, :]
        it = {"i": 0}

        def call(fn):
            def run():
                k, v = kv[it["i"] % layers]
                it["i"] += 1
                return fn(q, k, v, cur)
            return run

        def sdpa(q, k, v, cur):
            return F.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        live = sum(lens)
        nbytes = live * KVH * DH * 4 * 2 + 2 * q.numel() * 4 + b * 4
        reps = max(args.reps, layers)
        dev_ms, kernels = device_ms(call(ops.flash_decode), reps)
        print(json.dumps({
            "tag": args.tag, "cell": name, "B": b, "S": s, "cur_len": lens,
            "layers_cycled": layers, "max_abs_err": err,
            "ms": events_ms(call(ops.flash_decode), reps),
            "device_ms": dev_ms, "kernels_a_call": kernels,
            "plain_ms": events_ms(call(ref.flash_decode_ref), 8),
            "library_ms": events_ms(call(sdpa), 16),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "card": card}), flush=True)
        del kv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
