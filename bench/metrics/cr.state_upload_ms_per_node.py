"""cr.state_upload_ms_per_node: slow restores' uploads of recurrent-state
leaves to the card (``cr.restore.state`` spans, in
``PagedSession.restore_from_payload``) over the window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "cr.restore.state")
