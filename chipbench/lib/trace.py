"""The card's busy time over a whole untraced window (``CardClock``), the
traced stretch of a ``--trace 1`` run, and its reduction: device
busy seconds (the union of every kernel, copy and set interval), the
length of the stretch, device time by operation, the idle gaps labelled
by what the host was doing, device time inside each of the benchmark's
own spans, and the device time of one kernel by name.

The stretch is one ``torch.profiler`` session (CPU and CUDA activity)
around a span named ``STRETCH``; times come from the profiler's own
clock, host and device alike. The profiler is started once in set-up
(``warm``): its first start loads CUPTI, which takes seconds."""
from __future__ import annotations

import bisect
import contextlib

import numpy as np

STRETCH = "chipbench.stretch"
LABELLED = 400      # idle gaps labelled, longest first


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.events = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        with self._profile():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def stretch(self):
        """Profile what runs inside; the events are kept for ``reduce``."""
        from torch.profiler import record_function
        prof = self._profile()
        prof.start()
        try:
            with record_function(STRETCH):
                yield
            self.torch.cuda.synchronize()
        finally:
            prof.stop()
        # a span also appears on the device's timeline as an annotation:
        # only the host's copy is kept
        self.events = [(e.name(), on_dev, e.start_ns(),
                        e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()
                       for on_dev in ["CUDA" in str(e.device_type())]
                       if not (on_dev and e.is_user_annotation())]


class CardClock:
    """Device-only ``torch.profiler`` over a whole window: the seconds in
    which a kernel, copy or set ran on the card (the union of their
    intervals), and how many such operations ran. No host events are
    recorded, so the caller's path carries only the tracer's launch
    callbacks."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Load CUPTI in set-up: its first start takes seconds."""
        with self._profile():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    def stop(self) -> dict:
        """Wait for the card, stop, -> {busy_s, ops}."""
        self.torch.cuda.synchronize()
        self.prof.stop()
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in self.prof.profiler.kineto_results.events()
                 if "CUDA" in str(e.device_type())
                 and not e.is_user_annotation()]
        self.prof = None
        return {"busy_s": busy_ns(spans) * 1e-9, "ops": len(spans)}


def busy_ns(intervals) -> int:
    """Length of the union of [start, end] intervals."""
    return sum(b - a for a, b in _union(intervals))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(starts, ends, lo, hi) -> int:
    """Busy ns of the merged intervals (sorted ``starts``/``ends``) that
    fall inside [lo, hi]."""
    i = max(bisect.bisect_right(ends, lo), 0)
    j = bisect.bisect_left(starts, hi)
    return sum(min(ends[k], hi) - max(starts[k], lo) for k in range(i, j))


def reduce(events, spans: tuple[str, ...] = (), kernels: tuple[str, ...] = ()
           ) -> dict:
    """-> {window_s, busy_s, device_ops, idle_gaps, spans, kernels}.
    ``spans``: names of the benchmark's host spans; for each, its count,
    mean wall and mean device-busy seconds inside it. ``kernels``: name
    substrings; for each, launches and device seconds a launch."""
    host = [e for e in events if not e[1]]
    dev = [e for e in events if e[1]]
    top = [e for e in host if e[0] == STRETCH]
    if not top:
        return {}
    lo, hi = top[0][2], top[0][3]
    dev = [(n, max(a, lo), min(b, hi)) for n, _, a, b in dev
           if b > lo and a < hi]
    merged = _union([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in merged)
    m_start = [a for a, _ in merged]
    m_end = [b for _, b in merged]
    by_op: dict[str, int] = {}
    for n, a, b in dev:
        by_op[n] = by_op.get(n, 0) + (b - a)
    # idle gaps between busy intervals, the LABELLED longest, each named by
    # the shortest host event that spans its midpoint (what the host did)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    spans_all = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                        if b > a), reverse=True)[:LABELLED]
    inner = [e for e in host if e[0] != STRETCH]
    h_start = np.array([e[2] for e in inner], dtype=np.int64)
    h_end = np.array([e[3] for e in inner], dtype=np.int64)
    h_len = h_end - h_start
    gaps: dict[str, int] = {}
    for length, a, b in spans_all:
        mid = (a + b) // 2
        over = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        label = (inner[over[np.argmin(h_len[over])]][0] if over.size
                 else "host")
        gaps[label] = gaps.get(label, 0) + length
    out = {"window_s": (hi - lo) * 1e-9, "busy_s": busy * 1e-9,
           "device_ops": sorted(([n[:120], t * 1e-9] for n, t in
                                 by_op.items()), key=lambda x: -x[1])[:10],
           "idle_gaps": sorted(([n[:120], t * 1e-9] for n, t in
                                gaps.items()), key=lambda x: -x[1])[:10],
           "spans": {}, "kernels": {}}
    for s in spans:
        mine = [e for e in inner if e[0] == s]
        if mine:
            out["spans"][s] = {
                "count": len(mine),
                "wall_s": sum(e[3] - e[2] for e in mine) * 1e-9 / len(mine),
                "busy_s": sum(_covered(m_start, m_end, e[2], e[3])
                              for e in mine)
                * 1e-9 / len(mine)}
    for k in kernels:
        mine = [b - a for n, a, b in dev if k in n]
        if mine:
            out["kernels"][k] = {"launches": len(mine),
                                 "s_per_launch": sum(mine) * 1e-9 / len(mine)}
    return out
