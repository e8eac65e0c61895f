"""Benchmarks of the PyTorch port's kernels; each needs a CUDA card.

``gl_bisect`` times the fused Griffin-Lim solve with single stages switched
off; ``gl_probe`` times its two state layouts against each other;
``gl_profile`` traces one call and lists the card's time by kernel.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

__all__ = ["card", "time_cuda_ms"]


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
