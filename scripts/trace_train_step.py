"""Where the time of an LM train step goes, on the card.

Builds each ``--arch`` at its published width with its depth cut to
``--layers`` (``chip_smoke.py``'s phase 14: fp32 weights from a seeded
CUDA generator, TF32 off, ``launch.train``'s optimizer and its batch
from ``lm_batches``), takes two warm-up steps, then times on the device
(CUDA events, the launches queued behind a spin kernel so that the
host's time between them is hidden):

- ``loss_grads``: ``lm_loss`` and ``torch.autograd.grad`` (forward,
  remat's second forward and backward);
- ``adamw``: ``adamw_update`` on those gradients (clip, then the
  per-leaf update, unfused);
- ``step``: the whole ``make_train_step`` step;

and the step's wall ms (host clock, synchronized). A ``torch.profiler``
trace of ``--trace-steps`` steps gives the device time by op (ms a
step), the kernel launches a step and the device's busy share of the
wall. Prints the card's name and power limit, then one JSON line an
arch; the profiler's whole table goes to ``<--out>/trace_train_<arch>.txt``
(default ``build/scratch``):

    python scripts/trace_train_step.py [--arch llama3-8b olmoe-1b-7b] [--out DIR]
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def queued_ms(torch, fn, reps: int) -> float:
    """Device ms a call of ``fn``, its launches queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)           # ~0.2 s: covers the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(torch, fn, steps: int, path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = prof.key_averages()
    path.write_text(rows.table(sort_by="self_cuda_time_total", row_limit=80))
    kernels = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in kernels) / 1e3 / steps
    ops = {r.key: r.self_device_time_total / 1e3 / steps for r in rows
           if r.key.startswith("aten::") and r.self_device_time_total > 0}
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall,
            "launches": sum(r.count for r in rows
                            if r.key == "cudaLaunchKernel") / steps,
            "top_ops_ms": top}


def run(torch, arch: str, args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import named_tensors
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             warmup_cosine)
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch).model, n_layers=args.layers)
    model = tf.init_lm(cfg, seed=0, device="cuda")
    state = init_train_state(model)
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 5, 100))

    def loss_fn(p, tokens, labels):
        return tf.lm_loss(p, tokens, labels, dtype=torch.float32)

    step = make_train_step(loss_fn, opt)
    data = lm_batches(cfg.vocab, args.batch, args.seq + 1, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
    for _ in range(2):
        step(model, state, batch)
    names, leaves = zip(*named_tensors(model))

    def loss_grads():
        return torch.autograd.grad(loss_fn(model, **batch), leaves)

    grads = dict(zip(names, loss_grads()))
    out = {"arch": arch, "layers": cfg.n_layers, "B": args.batch,
           "S": args.seq,
           "loss_grads_ms": queued_ms(torch, loss_grads, 3),
           "adamw_ms": queued_ms(torch, lambda: adamw_update(
               opt, model, grads, state), 3),
           "step_ms": queued_ms(torch, lambda: step(model, state, batch), 3)}
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(model, state, batch)
        torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    out.update(trace(torch, lambda: step(model, state, batch),
                     args.trace_steps,
                     Path(args.out) / f"trace_train_{arch}.txt"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["llama3-8b", "olmoe-1b-7b"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--trace-steps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "scratch"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_train_step: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    Path(args.out).mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    for arch in args.arch:
        print(json.dumps(run(torch, arch, args)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
