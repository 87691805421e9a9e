"""engine.state_ms_per_step: the decode programs' copies of the batch's
recurrent states into their static buffers and the clones that rebind
them (``engine.state`` spans, in ``DecodeProgram.stage`` and ``absorb``)
over the window's ``Engine.step`` calls."""
from bench.harness.program import durations_ms, window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    steps = len(durations_ms(snap, "engine.step"))
    return sum(durations_ms(snap, "engine.state")) / steps if steps else 0.0
