"""A kernel's share of its roofline over the traced stretch: the least
time the counted work of the calls could take (``work.bound_s``) over the
device time of the profiler rows whose name holds one of the kernel's
names."""
import re

from ..work import bound_s


def share(m, names, work_key):
    t = m["trace"]
    if not t:
        return None
    pat = re.compile(r"\b(%s)\b" % "|".join(map(re.escape, names)))
    spent = sum(s for k, (s, _) in t["device_ops"].items() if pat.search(k))
    flops, nbytes = t["work"].get(work_key, (0.0, 0.0))
    if spent <= 0 or flops <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / spent
