"""cr.slow_restore_share: the share of the window's ``DeltaCR.restore`` calls
that rebuilt the state from its dump image (no template left)."""


def read(rec):
    r = rec["restores"]
    n = r["fast"] + r["slow"]
    return 100.0 * r["slow"] / n if n else None
