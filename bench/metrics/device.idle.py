"""device.idle: the share of the traced window in which no operation ran
on the device, from the profiler's trace."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
