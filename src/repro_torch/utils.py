"""Small shared utilities, the port of ``repro/utils.py``: logging, device
resolution, parameter-tree helpers, the precision policy and timing.

A tree here is what the port's models take as parameters: nested dicts
and lists whose leaves are tensors or ``nn.Module``s (a module stands for
its parameters, ``models.common.named_tensors``). The reference's
``key_iter`` and ``split_dict`` split JAX PRNG keys; the port draws from
seeded ``torch.Generator``s and has no counterpart."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s repro_torch] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

PyTree = Any


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card)
    unless the caller names another. A CUDA device without a card raises — the port never carries
    on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:           # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _MetaDraws(torch.Generator):
    """A CPU generator that names the ``meta`` device: a draw into a meta
    tensor computes nothing, so its state is never read."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    cuda, as ``resolve_device``), whose ``.device`` the initializers draw
    on. On ``meta``, which has no generator, one that draws nothing: a
    model built there (``launch/steps.py``'s dry-run cells) has shapes
    and dtypes and no values."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _MetaDraws().manual_seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------
def _leaves(tree: PyTree) -> list[torch.Tensor]:
    from repro_torch.models.common import tree_tensors
    return tree_tensors(tree)


def _map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` on every tensor of ``tree``; a module becomes the dict of
    its named parameters."""
    if isinstance(tree, torch.nn.Module):
        return {n: fn(p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _map2(fn: Callable, a: PyTree, b: PyTree) -> PyTree:
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def tree_size(tree: PyTree) -> int:
    """Total number of tensor elements in a tree."""
    return sum(t.numel() for t in _leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Floating tensors cast to ``dtype``; the others as they are."""
    return _map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def tree_zeros_like(tree: PyTree) -> PyTree:
    return _map(torch.zeros_like, tree)


def tree_norm(tree: PyTree) -> torch.Tensor:
    """The global L2 norm of every tensor in ``tree``, in fp32."""
    sq = [torch.sum(torch.square(t.float())) for t in _leaves(tree)]
    return torch.sqrt(sum(sq))


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return _map2(torch.add, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return _map(lambda t: t * s, a)


# ---------------------------------------------------------------------------
# Precision policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: params stored / compute / output dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_compute(self, tree: PyTree) -> PyTree:
        return tree_cast(tree, self.compute_dtype)


DEFAULT_POLICY = Policy()
FULL_PRECISION = Policy(torch.float32, torch.float32, torch.float32)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def _block_until_ready(out: PyTree) -> PyTree:
    """Wait for every card that holds a tensor of ``out`` (nested dicts,
    lists and tuples; other leaves are ignored), the reference's
    ``jax.block_until_ready``."""
    def cards(x):
        if isinstance(x, torch.Tensor):
            return {x.device} if x.is_cuda else set()
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            return set().union(*(cards(v) for v in x)) if x else set()
        return set()

    for dev in cards(out):
        torch.cuda.synchronize(dev)
    return out


def timed(fn: Callable, *args, n: int = 3, warmup: int = 1, **kw):
    """Best-of-n wall clock for ``fn``, each call waited for on the card;
    returns (seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = _block_until_ready(fn(*args, **kw))
    best = float("inf")
    for _ in range(n):
        t = Timer()
        out = _block_until_ready(fn(*args, **kw))
        best = min(best, t())
    return best, out


def human_bytes(n: float) -> str:
    for unit in ["B", "KiB", "MiB", "GiB", "TiB"]:
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PiB"


def human_count(n: float) -> str:
    for unit in ["", "K", "M", "B", "T"]:
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}Q"
