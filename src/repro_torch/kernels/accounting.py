"""Launch and collective accounting that a captured CUDA graph replays.

The kernel wrappers count their launches (``fn.launches``) and the
collectives note the bytes they move (``dist.collectives.LEDGER``) in
Python, as the launching code runs.  A CUDA graph runs that code once, at
capture, when nothing is launched, and then launches the same kernels at
every replay with no Python in between.  So while a thread captures
(inside :func:`recording`), its accounting updates are kept in a record
instead of applied, and the program that owns the graph applies the record
at each replay (:func:`replay`).  A count then means what it means on the
eager path: one per launch on the card.  Updates made by other threads
meanwhile (a dump worker's launches during the capture) apply at once.
:func:`warm_up_and_capture` makes such a graph and its record.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterator, List, Tuple

import torch

__all__ = ["Note", "count_launches", "record", "recording", "replay", "warm_up_and_capture"]

Note = Tuple[Callable[..., None], Tuple[Any, ...]]

_tls = threading.local()


def record(update: Callable[..., None], *args: Any) -> None:
    """``update(*args)`` now, or, while this thread records, at each replay."""
    notes = getattr(_tls, "notes", None)
    if notes is None:
        update(*args)
    else:
        notes.append((update, args))


def _add_launches(fn: Any, n: int) -> None:
    fn.launches += n


def count_launches(fn: Any, n: int = 1) -> None:
    """Add ``n`` launches to the count of kernel wrapper ``fn``."""
    if n:
        record(_add_launches, fn, n)


@contextlib.contextmanager
def recording() -> Iterator[List[Note]]:
    """Keep this thread's accounting updates in the yielded list."""
    if getattr(_tls, "notes", None) is not None:
        raise RuntimeError("this thread is already recording its accounting")
    notes: List[Note] = []
    _tls.notes = notes
    try:
        yield notes
    finally:
        _tls.notes = None


def replay(notes: List[Note]) -> None:
    """Apply a record once: one replay of the program that made it."""
    for update, args in notes:
        update(*args)


def warm_up_and_capture(body: Callable[[], Any], pool: Any, side: "torch.cuda.Stream"):
    """Run ``body()`` once on the stream ``side``, then capture it into a
    CUDA graph on ``side`` with its allocations in the graph memory pool
    ``pool`` and this thread's accounting recorded.

    The warm-up is a real call: its results and side effects are the
    step's (the capture runs nothing), and it builds the kernel library,
    cuBLAS's handles and workspaces on ``side`` before the capture.  Only
    the warm-up's returned value outlives it; its temporaries are freed
    before ``torch.cuda.graph`` empties the cache.  Returns (the warm-up's
    value, the graph, the captured call's value, which every replay
    rewrites, the record to :func:`replay` at each replay, the capture's
    host ms).  A failed capture raises."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        warm = body()
    current.wait_stream(side)
    side.synchronize()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with recording() as notes:
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            static = body()
    return warm, graph, static, notes, (time.perf_counter() - t0) * 1e3
