"""Spans and counters recorded inside the port, where the work happens.

A bounded flight recorder, on by default::

    from repro_torch import trace

    with trace.scope(trace.new_run()):          # what MCTS.run does
        with trace.span("cr.restore", ckpt=7) as sp:
            ...
            sp.set(path="slow")
        trace.count("dump.base_miss")
    snap = trace.snapshot(run)      # {"spans": [Span, ...], "counters": {name: n}}

A span is ``Span(name, t0_ns, t1_ns, thread, run, leaf, ckpt, attr)`` on
``time.perf_counter_ns``, the clock of the benchmark's recorder and of its
device-trace alignment, so the program's spans line up with a profiler's
device events with no conversion.  ``run`` and ``leaf`` come from the
calling thread's ``scope``; ``current()`` captures them so that work handed
to another thread (a dump on the worker) can re-enter them there.

Spans go into one ring of ``capacity`` entries; a span that a full ring
pushes out adds one to ``trace.dropped`` under its run, so a run whose
counters show ``trace.dropped`` lost spans.  Counters are keyed by
``(run, name)``.  While a ``torch.profiler`` session runs, each span also
opens a profiler range of its name: the program's spans then sit beside the
kernels in an operator's trace.  The range is a plain function range, not a
user annotation, so the profiler puts no span of the host on the device's
timeline.  A span never synchronizes the device.

``configure(enabled=False)`` turns recording off: ``span`` then returns one
shared no-op context manager and ``count`` and ``record`` return at once.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["Span", "TracedLock", "Tracer", "configure", "count", "current", "new_run", "record",
           "reset", "scope", "snapshot", "span"]

DROPPED = "trace.dropped"


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    thread: str
    run: Optional[int]
    leaf: Optional[int]
    ckpt: Optional[int]
    attr: Optional[Dict[str, Any]]


class _NoSpan:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, ckpt: Optional[int] = None, **attr: Any) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_tracer", "name", "ckpt", "attr", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, ckpt: Optional[int],
                 attr: Optional[Dict[str, Any]]):
        self._tracer, self.name, self.ckpt, self.attr = tracer, name, ckpt, attr
        self._range = None

    def set(self, ckpt: Optional[int] = None, **attr: Any) -> None:
        """Name the checkpoint or add attributes once they are known."""
        if ckpt is not None:
            self.ckpt = ckpt
        if attr:
            self.attr = dict(self.attr or {}, **attr)

    def __enter__(self) -> "_Span":
        if torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._add(self.name, self._t0, t1, self.ckpt, self.attr)
        return False


class Tracer:
    """The ring of spans, the counters and the run ids of one process."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self._lock = threading.Lock()
        # plain tuples in Span's field order; snapshot() names them
        self._ring: "collections.deque[tuple]" = collections.deque(maxlen=capacity)
        self._counters: Dict[Tuple[Optional[int], str], int] = {}
        self._runs = itertools.count(1)
        self._local = threading.local()
        self.enabled = enabled

    # ------------------------------------------------------------ context
    def current(self) -> Tuple[Optional[int], Optional[int]]:
        """The calling thread's ``(run, leaf)``."""
        loc = self._local
        return getattr(loc, "run", None), getattr(loc, "leaf", None)

    def new_run(self) -> int:
        return next(self._runs)

    def scope(self, run: Optional[int] = None, leaf: Optional[int] = None) -> "_Scope":
        """Stamp this thread's spans and counts with ``run`` and ``leaf``
        until the block ends."""
        return _Scope(self._local, run, leaf)

    # ---------------------------------------------------------- recording
    def span(self, name: str, ckpt: Optional[int] = None, **attr: Any):
        if not self.enabled:
            return _NO_SPAN
        return _Span(self, name, ckpt, attr or None)

    def record(self, name: str, t0_ns: int, t1_ns: Optional[int] = None,
               ckpt: Optional[int] = None, **attr: Any) -> None:
        """A span whose start was taken elsewhere (a dump's submission)."""
        if self.enabled:
            self._add(name, t0_ns, time.perf_counter_ns() if t1_ns is None else t1_ns,
                      ckpt, attr or None)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        key = (getattr(self._local, "run", None), name)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def _add(self, name: str, t0: int, t1: int, ckpt: Optional[int],
             attr: Optional[Dict[str, Any]]) -> None:
        loc = self._local
        s = (name, t0, t1, threading.current_thread().name, getattr(loc, "run", None),
             getattr(loc, "leaf", None), ckpt, attr)
        with self._lock:
            ring = self._ring
            if len(ring) == ring.maxlen:
                self._drop(ring[0])
            ring.append(s)

    def _drop(self, lost: tuple) -> None:
        key = (lost[4], DROPPED)
        self._counters[key] = self._counters.get(key, 0) + 1

    # ------------------------------------------------------------ reading
    def snapshot(self, run: Optional[int] = None) -> Dict[str, Any]:
        """``{"spans": [...], "counters": {...}}``: for the whole process
        with counters keyed by ``(run, name)``, or for ``run`` alone with
        counters keyed by name."""
        with self._lock:
            raw = list(self._ring)
            counters = dict(self._counters)
        if run is None:
            return {"spans": list(map(Span._make, raw)), "counters": counters}
        return {"spans": [Span._make(s) for s in raw if s[4] == run],
                "counters": {name: n for (r, name), n in counters.items() if r == run}}

    def configure(self, enabled: bool = True, capacity: int = 65536) -> None:
        """Turn recording on or off and bound the ring; shrinking it drops
        the oldest spans (counted in ``trace.dropped``)."""
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1, got {capacity}")
        with self._lock:
            if capacity != self._ring.maxlen:
                old = list(self._ring)
                for s in old[: max(0, len(old) - capacity)]:
                    self._drop(s)
                self._ring = collections.deque(old[-capacity:], maxlen=capacity)
            self.enabled = bool(enabled)

    def reset(self) -> None:
        """Forget every span and counter (run ids keep counting)."""
        with self._lock:
            self._ring.clear()
            self._counters.clear()


class _Scope:
    __slots__ = ("_local", "_ctx", "_saved")

    def __init__(self, local: threading.local, run: Optional[int], leaf: Optional[int]):
        self._local, self._ctx = local, (run, leaf)

    def __enter__(self) -> "_Scope":
        loc = self._local
        self._saved = getattr(loc, "run", None), getattr(loc, "leaf", None)
        loc.run, loc.leaf = self._ctx
        return self

    def __exit__(self, *exc) -> bool:
        self._local.run, self._local.leaf = self._saved
        return False


class TracedLock:
    """A reentrant lock whose contended acquisitions are spans of ``name``:
    a non-blocking try first, and a span only around the blocking acquire."""

    __slots__ = ("_lock", "_name")

    def __init__(self, name: str):
        self._lock = threading.RLock()
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        with _TRACER.span(self._name):
            return self._lock.acquire(True, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False


# The process's tracer; the functions below are its methods.
_TRACER = Tracer()
current = _TRACER.current
new_run = _TRACER.new_run
scope = _TRACER.scope
span = _TRACER.span
record = _TRACER.record
count = _TRACER.count
snapshot = _TRACER.snapshot
configure = _TRACER.configure
reset = _TRACER.reset
