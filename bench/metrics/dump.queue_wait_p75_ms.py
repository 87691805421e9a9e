"""dump.queue_wait_p75_ms: the 75th percentile of the window's dumps' waits
behind earlier dumps on the FIFO worker (``dump.queue`` spans, from the
submission to the dump's start), dumps that commit after the search
included.  The 75th for the reason ``dump.durable_p75_ms`` gives."""
from bench.harness.probes import percentile
from bench.harness.program import durations_ms, window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    waits = durations_ms(snap, "dump.queue")
    return percentile(waits, 75) if waits else 0.0
