"""The device trace of a traced run: ``torch.profiler`` over part of the
window, reduced to busy and idle time, time by device operation, and the
idle gaps named by what the host was doing then.

Kineto stamps its events on the wall clock (ns since the epoch); the
benchmark's own spans are on ``time.perf_counter_ns``.  ``start`` reads
both clocks at once and the spans are shifted by the difference.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Dict, List, Tuple

TOP = 10
UNPROBED = "no probed call (driver thread, scheduler wait, interpreter)"
SHORT_NS = 20_000
SHORT = "gaps under 20 us (between launches)"


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def idle_gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi] that no merged busy interval covers."""
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps, spans) -> Dict[str, Tuple[float, int, float]]:
    """Idle seconds by the host span that overlaps each gap most:
    {label: (seconds, gaps, longest gap in seconds)}.  ``spans`` are
    (name, t0, t1) on the trace's clock."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    longest_span = max((s[2] - s[1] for s in spans), default=0)

    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0, 0.0])
    for a, b in gaps:
        best, best_ov = (SHORT if b - a < SHORT_NS else UNPROBED), 0
        i = len(spans) if b - a < SHORT_NS else bisect.bisect_left(starts, a - longest_span)
        while i < len(spans) and spans[i][1] < b:
            name, s0, s1 = spans[i]
            ov = min(b, s1) - max(a, s0)
            if ov > best_ov:
                best, best_ov = name, ov
            i += 1
        rec = out[best]
        rec[0] += (b - a) / 1e9
        rec[1] += 1
        rec[2] = max(rec[2], (b - a) / 1e9)
    return {k: (v[0], v[1], v[2]) for k, v in out.items()}


class DeviceTrace:
    """``torch.profiler`` (host and device activity) between ``start`` and
    ``stop``; ``summary`` reduces it."""

    def __init__(self) -> None:
        self.prof = None
        self.offset_ns = 0
        self.t0 = self.t1 = self.p0 = self.p1 = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.p0 = time.perf_counter_ns()
        self.offset_ns = time.time_ns() - self.p0
        self.t0 = self.p0 + self.offset_ns

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.p1 = time.perf_counter_ns()
        self.t1 = self.p1 + self.offset_ns
        self.prof.stop()

    def summary(self, spans) -> Dict[str, Any]:
        """Busy and window seconds, the top device operations, idle seconds
        by host activity, the device seconds of every operation by name,
        and the traced interval on ``perf_counter_ns``.  ``spans`` are
        (name, t0, t1) on ``perf_counter_ns``."""
        from torch.autograd import DeviceType

        lo, hi = self.t0, self.t1
        by_name: Dict[str, float] = defaultdict(float)
        intervals = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            intervals.append((a, b))
            by_name[e.name()] += (b - a) / 1e9
        busy = merge(intervals)
        busy_s = sum(b - a for a, b in busy) / 1e9
        gaps = idle_gaps(busy, lo, hi)
        host = [(n, a + self.offset_ns, b + self.offset_ns) for n, a, b in spans
                if b + self.offset_ns > lo and a + self.offset_ns < hi]
        labelled = label_gaps(gaps, host)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        return {
            "busy_s": busy_s,
            "window_s": (hi - lo) / 1e9,
            "device_ops": [[n[:120], s] for n, s in ops[:TOP]],
            "idle_gaps": [[f"{k} ({n} gaps, longest {m * 1e3:.3f} ms)", s]
                          for k, (s, n, m) in sorted(labelled.items(), key=lambda kv: -kv[1][0])[:TOP]],
            "by_name": dict(by_name),
            "span_ns": (self.p0, self.p1),
        }
