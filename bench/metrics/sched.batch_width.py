"""sched.batch_width: the mean rows of an ``Engine.step`` in the window,
which is the batch the ``Scheduler`` formed."""


def read(rec):
    rows = [len(info[0]) for n, _, _, _, info in rec["spans"] if n == "engine.step"]
    return sum(rows) / len(rows) if rows else None
