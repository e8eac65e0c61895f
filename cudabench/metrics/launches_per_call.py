"""Device operations (kernels, memcpy, memset) a call, from the
profiler's rows over the traced stretch."""


def read(m):
    t = m["trace"]
    if not t or not t["calls"] or not t["events"]:
        return None
    return t["events"] / t["calls"]
