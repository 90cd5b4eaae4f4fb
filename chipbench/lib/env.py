"""Process set-up and device facts for one run: the fixed cache
directories inside the checkout, the card check, the card's clocks and
power sampled beside the window, and the check that neither JAX nor the
JAX package was loaded."""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
from pathlib import Path

# top-level module names that may never be loaded in a run (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

SMI_FIELDS = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def set_cache_dirs(root: Path) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run there compiles; libraries that would load
    JAX by themselves are told not to. Called before torch is imported."""
    build = root / "build"
    dirs = {"TORCH_EXTENSIONS_DIR": build / "torch_extensions",
            "TRITON_CACHE_DIR": build / "triton_cache",
            "CUDA_CACHE_PATH": build / "cuda_cache"}
    for k, v in dirs.items():
        os.environ[k] = str(v)
    os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0")
    return {k: str(v) for k, v in dirs.items()}


def forbidden_loaded() -> list[str]:
    """Names in ``sys.modules`` whose top-level name is a forbidden one."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def require_cards(torch, chips: int) -> None:
    """Raise unless ``chips`` CUDA cards are visible: a run never falls
    back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available: the benchmark runs "
                         "only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


class SmiSampler:
    """``nvidia-smi`` sampling clocks and power once a second over the
    window, in one child process that ``stop`` ends and waits for."""

    def __init__(self):
        self.proc = None

    def start(self) -> None:
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {}
        cols = list(zip(*rows))
        names = SMI_FIELDS.split(",")
        return {n: {"min": min(c), "median": statistics.median(c),
                    "max": max(c)} for n, c in zip(names, cols)} | {
            "samples": len(rows)}
