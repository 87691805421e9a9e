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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["Note", "count_launches", "record", "recording", "replay"]

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
