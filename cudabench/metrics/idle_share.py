"""Percent of the traced stretch in which no operation ran on the device:
``100 * (1 - busy / window)``."""


def read(m):
    t = m["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
