"""engine.step_ms: the mean ``Engine.step`` of the window on the host
clock; the step ends in its logits' copy to the host, so the device work
is done when it returns."""
from bench.harness.probes import span_ms


def read(rec):
    ms = span_ms(rec, "engine.step")
    return sum(ms) / len(ms) if ms else None
