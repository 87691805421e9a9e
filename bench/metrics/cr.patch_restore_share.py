"""cr.patch_restore_share: the share of the window's slow restores (``cr.restore``
spans with path "slow") that forked a live template and wrote only the
pages whose chunks differ (``cr.restore.patch``), in %; 0 where the program
counts no patch or the run restored nothing slow."""
from bench.harness.program import window_run


def read(rec):
    snap = window_run()
    if snap is None:
        return None
    slow = sum(1 for s in snap["spans"]
               if s.name == "cr.restore" and (s.attr or {}).get("path") == "slow")
    return 100.0 * snap["counters"].get("cr.restore.patch", 0) / slow if slow else 0.0
