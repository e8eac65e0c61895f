"""A profiled stretch after the window, and what its trace says.

The arithmetic is that of the measured package's
``benchmarks.trace_kernels``: device time by operation name from
``torch.profiler``'s device rows (kernels, memcpy and memset), launches
per call, busy time and idle share ``1 - busy / window``.  Two changes:
busy time is the union of the device rows' intervals (operations that
overlap count once), and the window is the host clock around the traced
calls and their final synchronise, inside the profiler (its start-up is
outside).  Each idle stretch between device rows is put down to the
harness span the host was in when it began (``loop`` outside any).
"""
from __future__ import annotations

from collections import defaultdict

PREFIX = "bench::"


def traced(runner, seconds: float, start: int) -> dict:
    """Run ``runner`` for ``seconds`` under the profiler; returns what the
    trace says."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .loop import Spans, synchronize
    activities = [ProfilerActivity.CPU]
    if torch.device(runner.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans = Spans(record=record_function)
    synchronize(runner.device)
    with profile(activities=activities) as prof:
        with record_function(PREFIX + "stretch"):
            run = runner.run(seconds, spans, start)
    return read(prof.events(), run)


def read(events, run: dict) -> dict:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        if e.name.startswith(PREFIX):
            if e.device_type != cuda:
                host.append((e.time_range.start, e.time_range.end,
                             e.name[len(PREFIX):]))
            continue
        if e.device_type == cuda:
            device.append((e.time_range.start, e.time_range.end, e.name))
    ops = defaultdict(lambda: [0.0, 0])
    for t0, t1, name in device:
        ops[name][0] += (t1 - t0) * 1e-6
        ops[name][1] += 1
    device.sort()
    busy, gaps = 0.0, []
    cur0 = cur1 = None
    for t0, t1, _ in device:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    stretch = [h for h in host if h[2] == "stretch"]
    if stretch and device:
        s0, s1 = stretch[0][0], stretch[0][1]
        if device[0][0] > s0:
            gaps.insert(0, (s0, device[0][0]))
        if s1 > cur1:
            gaps.append((cur1, s1))
    idle = defaultdict(float)
    inner = sorted((h for h in host if h[2] != "stretch"),
                   key=lambda h: h[0])
    j = 0
    for g0, g1 in gaps:
        while j < len(inner) and inner[j][1] < g0:
            j += 1
        name = "loop"
        for h0, h1, hname in inner[j:j + 4]:
            if h0 <= g0 <= h1:
                name = hname
        idle[name] += (g1 - g0) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {"calls": run["calls"], "window_s": run["seconds"],
            "busy_s": busy * 1e-6,
            "events": sum(n for _, n in ops.values()),
            "device_ops": {k: tuple(v) for k, v in ops.items()},
            "work": run["work"],
            "breakdown": {
                "device_ops": [[k[:200], v[0]] for k, v in top[:10]],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:10]}}
