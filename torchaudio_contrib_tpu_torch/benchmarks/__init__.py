"""Benchmarks of the PyTorch port's kernels; each needs a CUDA card.

``gl_bisect`` times the fused Griffin-Lim solve with single stages switched
off; ``gl_probe`` times its two state layouts against each other;
``gl_profile`` traces one call and lists the card's time by kernel;
``mel_profile`` does the same for the fused mel front end (config 2 forward
and forward + backward, a config 3 train step); ``mel_bisect`` times the
fused mel kernels at config 2 over the number of mels, which separates the
transform from the mel products; ``mel_ab`` prints those kernels' times for
whichever tree ``PYTHONPATH`` names, to compare a change with its parent
on one card, and ``gl_ab`` does so for the fused Griffin-Lim solve (both
routes, the rounds a block takes, the stage switches).  The ``gl_*``
benchmarks run the route the size takes and print it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

__all__ = ["card", "time_cuda_ms", "trace_kernels"]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark needs a CUDA device")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median over ``iters`` runs of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def trace_kernels(call, calls: int = 3, warmup: int = 2, top=None,
                  **labels) -> dict:
    """Traces ``calls`` runs of ``call`` with ``torch.profiler`` after
    ``warmup`` runs and prints one JSON line per device kernel (the
    ``top`` longest, or all: ms and launches per call, share of the busy
    time) and a summary line with
    ``labels``: busy ms per call, the host-clock ms per call of the traced
    window, and the idle share ``1 − busy / window`` (the window includes
    the profiler's own overhead).  Returns ``{"kernels": {name: (ms,
    launches) per call}, "busy_ms", "window_ms", "idle_share"}``."""
    from torch.profiler import ProfilerActivity, profile
    name = card()
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = {}
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        if us > 0:
            kernels[event.key] = (us / 1e3 / calls, event.count / calls)
    busy_ms = sum(ms for ms, _ in kernels.values())
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for key, (ms, count) in rows[:top]:
        print(json.dumps({"kernel": key[:80], "ms_per_call": ms,
                          "launches_per_call": count,
                          "share": ms / busy_ms, "card": name}), flush=True)
    out = {"kernels": kernels, "busy_ms": busy_ms, "window_ms": window_ms,
           "idle_share": 1.0 - busy_ms / window_ms}
    print(json.dumps({**labels, "busy_ms_per_call": busy_ms,
                      "window_ms_per_call": window_ms,
                      "idle_share": out["idle_share"], "card": name}),
          flush=True)
    return out
