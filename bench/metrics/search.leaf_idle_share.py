"""search.leaf_idle_share: the share of the parallel driver's leaf slots
that sat idle at the batch barrier, from the program's spans: 100 × (1 −
Σ ``search.leaf`` ÷ Σ over batches of ``search.batch`` × its leaves)."""
from bench.harness.program import durations_ms, window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    slots = sum((s.t1_ns - s.t0_ns) / 1e6 * s.attr["leaves"] for s in snap["spans"]
                if s.name == "search.batch")
    if slots <= 0:
        return 0.0
    return 100.0 * (1.0 - sum(durations_ms(snap, "search.leaf")) / slots)
