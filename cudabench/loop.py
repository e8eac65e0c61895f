"""The measured loops and the harness's own spans.

A driver's runner makes one call at a time (``step(i, spans)``) and says
which length the call had; :class:`Closed` runs calls back to back until
the window's time is up, then synchronises once, so the window holds all
the work and all the time.
"""
from __future__ import annotations

import time
from collections import Counter, defaultdict

import torch


class Spans:
    """Host seconds spent in each named span of the harness.  With
    ``record`` (``torch.profiler.record_function``) each span is also
    marked in the profiler's trace as ``bench::<name>``."""

    def __init__(self, record=None):
        self.total = defaultdict(float)
        self.record = record

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    __slots__ = ("spans", "name", "t", "rf")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = None
        if self.spans.record is not None:
            self.rf = self.spans.record("bench::" + self.name)
            self.rf.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.total[self.name] += time.perf_counter() - self.t
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Closed:
    """Base of a driver's runner: ``frames[l]`` and ``work[l]`` are a
    call's log-mel frames and counted work at length index ``l``."""

    device = "cuda"
    frames: list = []
    work: list = []

    def step(self, i: int, spans: Spans) -> int:
        raise NotImplementedError

    def run(self, seconds: float, spans: Spans, start: int) -> dict:
        synchronize(self.device)
        lengths = Counter()
        i = start
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            lengths[self.step(i, spans)] += 1
            i += 1
            if time.perf_counter() >= t_end:
                break
        with spans("sync"):
            synchronize(self.device)
        t1 = time.perf_counter()
        return self.summary(lengths, t1 - t0, i, spans)

    def summary(self, lengths: Counter, seconds: float, next_index: int,
                spans: Spans) -> dict:
        work = defaultdict(lambda: [0.0, 0.0])
        for l, n in lengths.items():
            for key, value in self.work[l].items():
                f, b = value if isinstance(value, tuple) else (value, 0.0)
                work[key][0] += n * f
                work[key][1] += n * b
        return {"calls": sum(lengths.values()),
                "frames": sum(n * self.frames[l] for l, n in lengths.items()),
                "seconds": seconds, "next": next_index,
                "work": {k: tuple(v) for k, v in work.items()},
                "spans": dict(spans.total), "failed": 0}
