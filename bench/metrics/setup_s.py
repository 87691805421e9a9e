"""setup_s: from the start of the run to the window: the weights drawn,
the port built, the trunk prefilled, every decode graph captured, the
trunk's first dump and the warm-up search."""


def read(rec):
    return rec["setup_s"]
