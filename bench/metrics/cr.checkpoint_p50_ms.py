"""cr.checkpoint_p50_ms: the median ``DeltaCR.checkpoint`` of the window (the
template fork and the dump's submission)."""
from bench.harness.probes import percentile, span_ms


def read(rec):
    return percentile(span_ms(rec, "cr.checkpoint"), 50)
