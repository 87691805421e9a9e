"""cr.image_decode_ms_per_node: slow restores' payloads rebuilt from their
images on the host (``cr.restore.decode`` spans) over the window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "cr.restore.decode")
