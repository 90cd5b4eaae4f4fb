"""The benchmark's yardstick arithmetic, frozen here so that a change to the
program cannot move it: the card's peaks, the percentiles and spreads,
and the bytes and operations of the hand kernel whose roofline the
benchmark reads.

The peaks are NVIDIA's data sheet for one H100 SXM (700 W). The kernel
byte count follows ``chip_smoke.py``'s ``beam_work``: each distinct input
byte read once and each output byte written once; one multiply-add is two
operations.
"""
from __future__ import annotations

import math
import statistics

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between closest ranks (numpy's default): a tail over all
    samples, never a median of chunk medians."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med


def roofline_ms(nbytes: float, flops: float,
                flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the HBM rate or
    operations over ``flops_per_s``, whichever is larger, and which."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------------------
# kernel work
# --------------------------------------------------------------------------
def beam_search_work(distinct_rows: float, distinct_lists: float,
                     pairs: float, *, d: int, m2: int, b: int, ef: int,
                     row_bytes: int) -> tuple[float, float]:
    """``beam_search`` of one launch -> (bytes, fp32 operations): each
    distinct row and neighbour list the traversal needs read once, the
    queries, entry points and entry distances, and the [B, ef] ids and
    distances written once; one multiply-add a (query, row) element."""
    nbytes = (distinct_rows * row_bytes + distinct_lists * m2 * 4
              + b * d * 4 + b * 8 + b * ef * 8)
    return float(nbytes), 2.0 * pairs * d
