"""What the program's own spans say of a traced stretch.

The port marks its layers as ``tac::<name>`` spans while a profiler
records (``torchaudio_contrib_tpu_torch.utils.trace``).  :func:`read`
takes the same ``torch.profiler`` events as ``devtrace.read`` and puts
every device row (kernel, memcpy, memset; no annotation) down to a cause:

* the innermost ``tac::`` span open on the thread that launched the row,
  when it launched it: the CUDA runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) that shares the row's correlation id holds
  the thread and the time, for PyTorch's operators and for kernels
  launched from outside them alike (torch 2.11's events carry no link from
  a row to its operator);
* failing that, the innermost ``tac::`` span open on any thread then:
  autograd's engine launches a backward on its own thread, inside the
  caller's span;
* failing that, the innermost harness span open then (``bench::<name>``,
  as ``devtrace`` puts idle time down), else ``loop``.

Each idle stretch of the device's timeline (as ``devtrace`` finds them) is
put down by the same rule at its start.  Per cause, a call of the stretch:
the span's occurrences and host self milliseconds (its time less its child
spans', on the profiler's clock; ``tac::`` spans only), device
milliseconds, device rows, idle milliseconds and the device operations by
name; the share of device time put down to each kind of cause; the moves of
the program's counters over the stretch; and ``glue``: the device rows put
down to a ``tac::fused_mel*`` span other than B1's and B2's own kernels
(``metrics/b1_roofline.py``'s and ``b2_roofline.py``'s ``KERNELS``), in
milliseconds and rows a call.

Run alone, this runs one cell as ``run.py`` does, with the traced stretch
also read here, and prints ``{"program": ...}`` before the harness's lines:

    python3 cudabench/progtrace.py --workload c2_train --seed 12345 \
        --seconds 10 --trace 1
"""
from __future__ import annotations

import json
import re
import sys
from collections import defaultdict
from pathlib import Path

TAC = "tac::"
HARNESS = "bench::"
# CUDA API calls: cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernelEx, ...
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
TOP_OPS = 8


def _innermost(open_spans):
    """The innermost of the spans open on any thread: the latest begun."""
    tops = [s[-1] for s in open_spans.values() if s]
    return max(tops, key=lambda s: (s[0], -s[1])) if tops else None


def _sweep(spans, queries):
    """``queries`` ``(time, thread, key)``, each answered with ``(own,
    any)``: the innermost span of ``spans`` ``(start, end, thread, name)``
    open at ``time`` on ``thread``, and on any thread.  Spans nest on their
    thread; a span open at a query's time includes its ends.  Also returns
    each span's innermost enclosing span on its own thread."""
    marks = []
    for i, (t0, t1, _, _) in enumerate(spans):
        marks.append((t0, 0, i))
        marks.append((t1, 2, i))
    for j, (t, _, _) in enumerate(queries):
        marks.append((t, 1, j))
    marks.sort()
    open_spans = defaultdict(list)
    answers, parent = {}, {}
    for _, kind, i in marks:
        if kind == 0:
            s = spans[i]
            stack = open_spans[s[2]]
            parent[i] = stack[-1][4] if stack else None
            stack.append((*s, i))
        elif kind == 2:
            stack = open_spans[spans[i][2]]
            for k in range(len(stack) - 1, -1, -1):
                if stack[k][4] == i:
                    del stack[k]
                    break
        else:
            t, thread, key = queries[i]
            stack = open_spans.get(thread)
            answers[key] = (stack[-1][4] if stack else None,
                            (_innermost(open_spans) or (None,) * 5)[4])
    return answers, parent


def _gaps(rows, stretch):
    """Idle stretches between the device rows ``(start, end)``, and from
    the stretch's start and to its end, as ``devtrace.read`` finds them."""
    gaps, cur1 = [], None
    for t0, t1 in sorted(rows):
        if cur1 is not None and t0 > cur1:
            gaps.append((cur1, t0))
        cur1 = t1 if cur1 is None else max(cur1, t1)
    if stretch and rows:
        first = min(t0 for t0, _ in rows)
        if first > stretch[0]:
            gaps.insert(0, (stretch[0], first))
        if stretch[1] > cur1:
            gaps.append((cur1, stretch[1]))
    return gaps


def _kernel_pattern():
    from .metrics import b1_roofline, b2_roofline
    names = b1_roofline.KERNELS + b2_roofline.KERNELS
    return re.compile(r"\b(%s)\b" % "|".join(map(re.escape, names)))


def read(events, run: dict, counters: dict | None = None) -> dict:
    """The program's account of a traced stretch (module docstring);
    ``counters`` is what the program's counters moved over it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows, tac, harness, stretch, runtime = [], [], [], None, {}
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith((TAC, HARNESS))):
                rows.append((t0, t1, e.name, e.id))
        elif e.name.startswith(TAC):
            tac.append((t0, t1, e.thread, e.name))
        elif e.name == HARNESS + "stretch":
            stretch = (t0, t1)
        elif e.name.startswith(HARNESS):
            harness.append((t0, t1, e.thread, e.name))
        elif RUNTIME.match(e.name):
            runtime[e.id] = e
    tac.sort(key=lambda s: (s[0], -s[1]))
    harness.sort(key=lambda s: (s[0], -s[1]))
    queries = []
    for k, (t0, _, _, cid) in enumerate(rows):
        by = runtime.get(cid)
        queries.append((by.time_range.start, by.thread, k) if by
                       else (t0, None, k))
    gaps = _gaps([(r[0], r[1]) for r in rows], stretch)
    queries += [(g0, None, ("gap", k)) for k, (g0, _) in enumerate(gaps)]
    in_tac, parent = _sweep(tac, queries)
    in_harness, _ = _sweep(harness, queries)

    def cause(key):
        own, anyone = in_tac[key]
        i = own if own is not None else anyone
        if i is not None:
            return tac[i][3]
        i = in_harness[key][1]
        return harness[i][3] if i is not None else "loop"

    calls = max(run["calls"], 1)
    per = defaultdict(lambda: {"n": 0, "host_self_ms": 0.0, "device_ms": 0.0,
                               "rows": 0, "idle_ms": 0.0,
                               "ops": defaultdict(lambda: [0.0, 0])})
    for i, (t0, t1, _, name) in enumerate(tac):
        per[name]["n"] += 1
        per[name]["host_self_ms"] += (t1 - t0) * 1e-3
        if parent[i] is not None:
            per[tac[parent[i]][3]]["host_self_ms"] -= (t1 - t0) * 1e-3
    kernels = _kernel_pattern()
    glue_us, glue_rows, total_us = 0.0, 0, 0.0
    kinds = defaultdict(float)
    for k, (t0, t1, name, _) in enumerate(rows):
        by = cause(k)
        p = per[by]
        p["device_ms"] += (t1 - t0) * 1e-3
        p["rows"] += 1
        p["ops"][name][0] += (t1 - t0) * 1e-3
        p["ops"][name][1] += 1
        total_us += t1 - t0
        kinds[by.split("::")[0] if "::" in by else by] += t1 - t0
        if by.startswith(TAC + "fused_mel") and not kernels.search(name):
            glue_us += t1 - t0
            glue_rows += 1
    for k, (g0, g1) in enumerate(gaps):
        per[cause(("gap", k))]["idle_ms"] += (g1 - g0) * 1e-3
    spans = {}
    for name, p in sorted(per.items(), key=lambda kv: -kv[1]["device_ms"]):
        top = sorted(p["ops"].items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        entry = {}
        if name.startswith(TAC):
            entry["n"] = p["n"] / calls
            entry["host_self_ms"] = p["host_self_ms"] / calls
        entry.update(
            device_ms=p["device_ms"] / calls, rows=p["rows"] / calls,
            idle_ms=p["idle_ms"] / calls,
            ops=[[k[:120], v[0] / calls, v[1] / calls] for k, v in top])
        spans[name] = entry
    return {"calls": run["calls"],
            "calls_per_s": run["calls"] / run["seconds"]
            if run["seconds"] > 0 else None,
            "device_ms": total_us * 1e-3 / calls, "rows": len(rows) / calls,
            "device_share": {k: v / total_us for k, v in kinds.items()}
            if total_us > 0 else {},
            "glue": {"ms_per_call": glue_us * 1e-3 / calls,
                     "launches_per_call": glue_rows / calls} if rows else None,
            "counters": counters,
            "spans": spans}


def _program_counts():
    """The program's counters, or None where it has none."""
    try:
        from torchaudio_contrib_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.counts()


def traced(runner, seconds: float, start: int) -> dict:
    """``devtrace.traced``, with :func:`read` of the same events printed
    as ``{"program": ...}`` and kept as ``["program"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace
    from .loop import Spans, synchronize
    activities = [ProfilerActivity.CPU]
    if torch.device(runner.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans = Spans(record=record_function)
    synchronize(runner.device)
    before = _program_counts()
    with profile(activities=activities) as prof:
        with record_function(devtrace.PREFIX + "stretch"):
            run = runner.run(seconds, spans, start)
    after = _program_counts()
    moves = ({k: v - before[k] for k, v in after.items()}
             if before is not None else None)
    events = prof.events()
    out = devtrace.read(events, run)
    out["program"] = read(events, run, moves)
    print(json.dumps({"program": out["program"]}), flush=True)
    return out


def main(argv, t_start: float) -> int:
    """``harness.main`` with the traced stretch read by :func:`traced`."""
    from . import devtrace, harness
    devtrace.traced = traced
    return harness.main(argv, t_start)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from cudabench import progtrace, run
    sys.exit(progtrace.main(sys.argv[1:], run.T_START))
