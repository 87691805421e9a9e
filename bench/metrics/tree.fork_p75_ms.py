"""tree.fork_p75_ms: the 75th percentile of every ``SandboxTree.fork`` of
a selected node in the window, fast or slow, on the host clock.
The 75th is the highest percentile with ten samples beyond it in a
window of 45 to 60 nodes."""
from bench.harness.probes import percentile, span_ms


def read(rec):
    return percentile(span_ms(rec, "rollback"), 75)
