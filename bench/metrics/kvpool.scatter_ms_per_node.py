"""kvpool.scatter_ms_per_node: slow restores' page uploads and
``index_copy_`` inside the pool lock (``kvpool.scatter`` spans) over the
window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "kvpool.scatter")
