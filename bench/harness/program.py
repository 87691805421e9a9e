"""The program's own spans and counters (``repro_torch.trace``), read in
the run's process after the window.

The window is one ``MCTS.run``: the newest run of the process that has a
``search.run`` span.  Its spans carry the run's id, the dumps that commit
after the search's end among them, so set-up, the warm-up search and the
check's restores stay out.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def window_run() -> Optional[Dict[str, Any]]:
    """``{"spans", "counters"}`` of the window's run; None where the program
    has no tracer, no run has a ``search.run`` span, or spans of the run
    were lost to a full ring (``trace.dropped``)."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    runs = [s.run for s in trace.snapshot()["spans"] if s.name == "search.run"]
    if not runs:
        return None
    snap = trace.snapshot(max(runs))
    if snap["counters"].get("trace.dropped", 0) > 0:
        return None
    return snap


def durations_ms(snap: Dict[str, Any], name: str, thread_prefix: str = ""):
    """Durations in ms of the run's spans ``name`` on threads whose name
    starts with ``thread_prefix``."""
    return [(s.t1_ns - s.t0_ns) / 1e6 for s in snap["spans"]
            if s.name == name and s.thread.startswith(thread_prefix)]


def per_node_ms(rec: Dict[str, Any], name: str, thread_prefix: str = "") -> Optional[float]:
    """Summed ms of the run's spans ``name`` over the window's nodes."""
    snap = window_run()
    if snap is None or not rec["nodes"]:
        return None
    return sum(durations_ms(snap, name, thread_prefix)) / rec["nodes"]
