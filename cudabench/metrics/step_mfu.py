"""Percent of the card's FP32 peak that the window's counted operations
(``work.py``: the front end, the convolutions and the head, forward and
backward as the cell runs them) fill over the window's wall time.  Read
from the untraced window of the traced run."""
from ..work import PEAK_FP32


def read(m):
    w = m["window"]
    flops = w["work"].get("step", (0.0, 0.0))[0]
    if flops <= 0 or w["seconds"] <= 0:
        return None
    return 100.0 * flops / w["seconds"] / PEAK_FP32
