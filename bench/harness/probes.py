"""Spans and counts taken from outside the program.

The benchmark wraps methods of the program's instances (never its classes'
code) and records, per call, the host clock before and after, the thread
and whatever the caller extracts from the arguments and the result.  The
records stay in memory until the run ends.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class Recorder:
    """Thread-safe lists of spans ``(name, t0_ns, t1_ns, thread, info)``
    on ``time.perf_counter_ns``, and of free-form samples by name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.spans: List[Tuple[str, int, int, int, Any]] = []
        self.samples: Dict[str, List[Any]] = {}
        self.active = False

    def span(self, name: str, t0: int, t1: int, info: Any = None) -> None:
        if self.active:
            with self._lock:
                self.spans.append((name, t0, t1, threading.get_ident(), info))

    def sample(self, name: str, value: Any) -> None:
        if self.active:
            with self._lock:
                self.samples.setdefault(name, []).append(value)

    def infos(self, name: str) -> List[Any]:
        with self._lock:
            return [info for n, _, _, _, info in self.spans if n == name]


def wrap(obj: Any, attr: str, rec: Recorder, name: str,
         info: Optional[Callable[[tuple, dict, Any], Any]] = None,
         before: Optional[Callable[[tuple, dict], Any]] = None) -> Callable[[], None]:
    """Replace the bound method ``obj.attr`` by one that records a span
    named ``name`` around each call.  ``before(args, kwargs)`` runs before
    the call; ``info(args, kwargs, result_or_pre)`` gives the span's info.
    Returns a function that puts the original back."""
    orig = getattr(obj, attr)

    @functools.wraps(orig)
    def timed(*args, **kwargs):
        pre = before(args, kwargs) if before is not None else None
        t0 = time.perf_counter_ns()
        out = orig(*args, **kwargs)
        t1 = time.perf_counter_ns()
        rec.span(name, t0, t1, info(args, kwargs, (out, pre)) if info is not None else None)
        return out

    setattr(obj, attr, timed)
    return lambda: setattr(obj, attr, orig)


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between order statistics; None when there are none."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def span_ms(rec, name: str):
    """Durations in ms of the spans ``name`` among a run's records."""
    return [(t1 - t0) / 1e6 for n, t0, t1, _, _ in rec["spans"] if n == name]
