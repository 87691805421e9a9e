"""kvpool.lock_wait_ms_per_node: the leaf threads' waits for a contended
``PagePool`` lock (``kvpool.lock_wait`` spans on ``mcts-leaf`` threads)
over the window's nodes."""
from bench.harness.program import per_node_ms


def read(rec):
    return per_node_ms(rec, "kvpool.lock_wait", "mcts-leaf")
