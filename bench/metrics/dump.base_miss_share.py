"""dump.base_miss_share: the share of the window's dumps given a parent
image whose parent generation had left the pipeline's cache, so the
session drained in full (``dump.base_miss`` over ``dump.with_parent``)."""
from bench.harness.program import window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    c = snap["counters"]
    n = c.get("dump.with_parent", 0)
    return 100.0 * c.get("dump.base_miss", 0) / n if n else 0.0
