"""tree.fork_p50_ms: the median ``SandboxTree.fork`` of the window."""
from bench.harness.probes import percentile, span_ms


def read(rec):
    return percentile(span_ms(rec, "rollback"), 50)
