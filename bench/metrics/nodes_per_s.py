"""nodes_per_s: the nodes the search added in the window over the time
from the search's start until the last dump of the window committed (the
search's own run, from its root checkpoint to its last batch, and then the
drain of its dumps), on the host clock: a node counts once it is durable,
so work deferred past the search's end is still timed."""


def read(rec):
    secs = rec["window_s"] + rec["drain_s"]
    return rec["nodes"] / secs if secs > 0 else None
