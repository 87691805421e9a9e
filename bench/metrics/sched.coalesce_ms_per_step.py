"""sched.coalesce_ms_per_step: the ``Scheduler``'s batch-window waits
(``sched.coalesce`` spans) over the window's ``Engine.step`` calls."""
from bench.harness.program import durations_ms, window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    steps = len(durations_ms(snap, "engine.step"))
    return sum(durations_ms(snap, "sched.coalesce")) / steps if steps else 0.0
