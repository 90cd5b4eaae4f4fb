"""The yardstick's arithmetic against hand counts: percentiles over all
samples (not medians of chunks), spreads, rooflines, the beam kernel's
bytes, and the beam traversal's work."""
import statistics

import numpy as np
import pytest
import torch

from chipbench.lib import arith, beam_work

def test_percentile_is_over_every_sample():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 50) == 50.5
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    assert arith.percentile([3.0], 95) == 3.0
    rng = np.random.default_rng(0)
    v = rng.exponential(size=1001)
    assert arith.percentile(v, 90) == pytest.approx(np.percentile(v, 90))
    # one slow chunk: the tail of all samples sees it, a median of chunk
    # tails would not
    lat = [1.0] * 90 + [10.0] * 10
    chunks = [lat[i:i + 10] for i in range(0, 100, 10)]
    assert arith.percentile(lat, 95) == 10.0
    assert statistics.median(arith.percentile(c, 95) for c in chunks) == 1.0


def test_spread_is_the_quartile_gap_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert arith.spread(v) == pytest.approx((q3 - q1) / med)


def test_roofline_takes_the_larger_bound():
    ms, by = arith.roofline_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = arith.roofline_ms(1.0, 67e9)
    assert ms == pytest.approx(1.0) and by == "operations"


def test_beam_search_work_by_hand():
    nbytes, flops = arith.beam_search_work(100, 20, 700, d=4, m2=10, b=3,
                                           ef=8, row_bytes=16)
    assert nbytes == 100 * 16 + 20 * 10 * 4 + 3 * 4 * 4 + 3 * 8 + 3 * 8 * 8
    assert flops == 2 * 700 * 4


def test_beam_traversal_counts_a_line_graph():
    """Five rows on a line, each linked to its neighbours; a query at row 4
    entering at row 0 walks the line: every row is read once, every node's
    list expanded, each new (query, row) distance computed once."""
    x = torch.tensor([[float(i), 1.0] for i in range(5)])
    x = x / x.norm(dim=1, keepdim=True)
    nbrs = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, -1]],
                        dtype=torch.int32)
    q = x[4:5].clone()
    ep = torch.tensor([0], dtype=torch.int32)
    ep_d = 1.0 - (x[0] * q[0]).sum().reshape(1)
    w = beam_work.traversal(x, nbrs, q, ep, ep_d, ef=8, expand_t=1)
    assert (w["rows"], w["lists"], w["pairs"]) == (4, 5, 4)
    # the beam ends holding every row, nearest to the query first
    assert w["ids"][0, :5].tolist() == [4, 3, 2, 1, 0]


def test_card_busy_is_the_union_of_device_intervals():
    from chipbench.lib import spec, trace
    # overlapping copies and kernels count once; a gap counts not at all
    spans = [(0, 10), (5, 20), (30, 40), (32, 35), (40, 41)]
    assert trace.busy_ns(spans) == 20 + 11
    rd = spec.reader("search_card_us_per_query")
    assert rd.read({"card_busy": {"busy_s": 2.0, "ops": 9},
                    "queries": 1_000_000}) == pytest.approx(2.0)
    assert rd.read({"queries": 10}) is None
