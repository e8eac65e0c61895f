"""Host milliseconds a call spends inside the program's entry (the
harness's ``entry`` and ``grad`` spans, before any synchronise), over the
window of the traced run.  It reads the entry's dispatch only where the
host paces the loop: in a card-paced cell the host blocks on a full launch
queue and the span is the step time again, so such cells do not report
it."""


def read(m):
    w = m["window"]
    spent = w["spans"].get("entry", 0.0) + w["spans"].get("grad", 0.0)
    return 1e3 * spent / w["calls"] if w["calls"] and spent > 0 else None
