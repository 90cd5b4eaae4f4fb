"""Named host-side counters for launch and sync economics.

Tests, benches and ``chip_smoke.py`` read these to show what a run
submitted: ``hnsw.search_graph`` searches, ``hnsw.beam_launches`` layer-0
beam launches, ``hnsw.descent_launches`` one-launch greedy descents on the
card (beside ``hnsw.descent_launches.<codec>``; each also counts as a
``kernel.gather_distance`` launch, so a run tells them from per-hop
gathers), ``hnsw.h2d_bytes`` host-to-device graph
bytes, ``hnsw.host_syncs`` device-to-host waits in the search's Python
loops, and one counter per hand kernel (``kernel.gather_distance``,
``kernel.beam_search``, ``kernel.flash_decode``,
``kernel.distance_topk``, ``kernel.embedding_bag``) that ``kernels.ops``
bumps where it launches the kernel and nowhere else — the CPU branch,
which runs the plain PyTorch version, never counts. Beside each,
``kernel.<name>.<codec>`` (fp32, bf16, int8) counts the launches of the
instance for that row (or table) codec. A sharded HNSW search counts
``stacked.search_stacked`` once and ``stacked.beam_launches`` for each
non-empty shard's layer-0 beam.

Counters are bumped at the Python boundary. Not thread-safe by design:
the serving layer serializes device work onto one dispatcher.
"""
from __future__ import annotations

from collections import defaultdict

_COUNTS: defaultdict[str, int] = defaultdict(int)

KERNEL_COUNTERS = ("kernel.gather_distance", "kernel.beam_search",
                   "kernel.flash_decode", "kernel.distance_topk",
                   "kernel.embedding_bag")


def bump(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (created at 0 on first use)."""
    _COUNTS[name] += int(n)


def get(name: str) -> int:
    return _COUNTS[name]


def reset(*names: str) -> None:
    """Reset the given counters, or ALL counters when called bare."""
    if names:
        for name in names:
            _COUNTS.pop(name, None)
    else:
        _COUNTS.clear()


def snapshot() -> dict[str, int]:
    return dict(_COUNTS)


def beam_launches(beam_impl: str, ef: int,
                  max_iters: int | None = None) -> int:
    """Device launches one search contributes on the layer-0 beam path:
    ``fused`` is ONE kernel launch; ``jnp`` (the per-hop reference, name
    kept from the JAX package) re-dispatches the gather + sort work every
    hop, bounded by ``max_iters`` (default ef)."""
    if beam_impl == "fused":
        return 1
    return max(int(ef if max_iters is None else max_iters), 1)
