"""cr.image_wait_ms_per_node: slow restores blocked on their node's dump
(``cr.restore.image_wait`` spans) over the window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "cr.restore.image_wait")
