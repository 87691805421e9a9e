"""search.nodes_per_batch: ``MCTSStats.nodes`` over ``parallel_batches``:
the nodes one batch of parallel leaves adds."""


def read(rec):
    return rec["nodes"] / rec["batches"] if rec["batches"] else None
