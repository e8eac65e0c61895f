"""Log-mel frames the entry completed in the window over the window's
wall time (host clock; the window ends with a synchronise).  Training
cells count the frames of the steps completed."""


def read(m):
    w = m["window"]
    return w["frames"] / w["seconds"] if w["seconds"] > 0 else None
