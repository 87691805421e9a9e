"""dump.state_ms_per_node: the dumps' device-to-host copy and blake2b of
recurrent-state leaves (``dump.state`` spans) over the window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "dump.state")
