"""dump.state_bytes_per_node: the bytes of recurrent state the window's
dumps encoded (``dump.state_bytes``, counted by
``DeltaDumpPipeline.encode_generation`` for each dirty state leaf it
digest-encodes on the host) over the window's nodes."""
from bench.harness.program import window_run


def read(rec):
    snap = window_run()
    if snap is None or not rec["nodes"]:
        return None
    return snap["counters"].get("dump.state_bytes", 0) / rec["nodes"]
