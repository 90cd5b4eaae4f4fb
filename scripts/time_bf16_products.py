#!/usr/bin/env python3
"""Time the forms a 16-bit product can take at llama3-8b's decode shapes
(4 tokens; wq/wo, w1/w3, w2, wk/wv) on the card, and check that a bf16
``F.linear`` rounds as the fp32-output product and a cast do.

    python scripts/time_bf16_products.py

For each shape and form: the host's enqueue µs a call, the wall µs a
call (enqueue, then a sync) and the device µs a call with the calls
queued behind a spin kernel. Forms: ``F.linear`` in bf16; ``torch.mm``
with ``out_dtype=torch.float32``, alone and cast to bf16; the operands
widened to fp32. Then the share of elements where the bf16 ``F.linear``
differs from the fp32-output product cast to bf16, with
``allow_bf16_reduced_precision_reduction`` on and off. Needs a card."""
import time

import torch
import torch.nn.functional as F

SHAPES = [(4, 4096, 4096), (4, 14336, 4096), (4, 4096, 14336),
          (4, 1024, 4096)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_bf16_products: needs an NVIDIA card")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for m, n, k in SHAPES:
        x = torch.randn(m, k, device="cuda", generator=g).to(bf)
        w = (torch.randn(n, k, device="cuda", generator=g) * 0.02).to(bf)
        forms = {
            "linear_bf16": lambda: F.linear(x, w),
            "mm_out_f32": lambda: torch.mm(x, w.t(), out_dtype=torch.float32),
            "mm_out_f32_cast": lambda: torch.mm(
                x, w.t(), out_dtype=torch.float32).to(bf),
            "widen_f32": lambda: F.linear(x.float(), w.float()),
        }
        for name, fn in forms.items():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 200 * 1e6
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            s.record()
            for _ in range(200):
                fn()
            e.record()
            torch.cuda.synchronize()
            print(f"{m}x{n}x{k} {name}: enqueue {host:.1f} us, wall "
                  f"{wall:.1f} us, device (queued) "
                  f"{s.elapsed_time(e) / 200 * 1e3:.1f} us", flush=True)
        want = torch.mm(x, w.t(), out_dtype=torch.float32).to(bf)
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            share = (F.linear(x, w) != want).float().mean().item()
            print(f"  reduced_precision_reduction={on}: bf16 linear differs "
                  f"from the fp32 product cast on {share:.5f} of elements",
                  flush=True)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


if __name__ == "__main__":
    main()
