"""kvpool.cow_pages_per_node: ``PoolStats.cow_copies`` made in the window
over the nodes the search added."""


def read(rec):
    return rec["cow_pages"] / rec["nodes"] if rec["nodes"] else None
