"""engine.host_ms: the mean host time of an ``Engine.step`` outside its
graph replay and logits copy: ``engine.step`` (from the pool lock's
acquisition to the last sampled token) less its ``engine.run``."""
from bench.harness.program import durations_ms, window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    steps = durations_ms(snap, "engine.step")
    if not steps:
        return 0.0
    return (sum(steps) - sum(durations_ms(snap, "engine.run"))) / len(steps)
