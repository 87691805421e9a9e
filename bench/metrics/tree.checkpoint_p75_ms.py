"""tree.checkpoint_p75_ms: the 75th percentile of every ``SandboxTree.checkpoint``
of a leaf in the window, on the host clock: the time a
node's agent is blocked.
The 75th is the highest percentile with ten samples beyond it in a
window of 45 to 60 nodes."""
from bench.harness.probes import percentile, span_ms


def read(rec):
    return percentile(span_ms(rec, "checkpoint"), 75)
