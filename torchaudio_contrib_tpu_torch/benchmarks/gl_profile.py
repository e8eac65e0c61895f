"""Where one fused Griffin-Lim call spends the card's time.

    python -m torchaudio_contrib_tpu_torch.benchmarks.gl_profile [fft hop]

Traces ``calls`` whole calls of the fused Griffin-Lim (operand set-up, the
solve of ``csrc/fused_gl.cu``, the final inverse transform) with
``torch.profiler`` after two warm-ups, at the Griffin-Lim benchmark's shape
(8 x 110 250 samples, 32 iterations; fft 1024 / hop 256 unless given), and
prints one JSON line per device kernel (ms and launches per call, share of
the busy time) and a summary line: busy ms per call, the host-clock ms per
call of the traced window, and the idle share ``1 − busy / window`` (the
window includes the profiler's own overhead).  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from . import card
from ..ops.fused_griffinlim import _gl_fused
from ..ops.stft import stft


def run(fft: int = 1024, hop: int = 256, n_iter: int = 32, batch: int = 8,
        samples: int = 110250, calls: int = 3, seed: int = 0) -> dict:
    """``{"kernels": {name: (ms, launches) per call}, "busy_ms", "window_ms",
    "idle_share"}``; prints the JSON lines."""
    from torch.profiler import ProfilerActivity, profile
    name = card()
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, samples)).astype(np.float32)).cuda()
    mag = stft(x, fft, hop).abs()

    def call():
        return _gl_fused(mag, fft, hop, "hann", n_iter, 0.99, samples, True)

    for _ in range(2):
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
    for key, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"kernel": key[:80], "ms_per_call": ms,
                          "launches_per_call": count,
                          "share": ms / busy_ms, "card": name}), flush=True)
    out = {"kernels": kernels, "busy_ms": busy_ms, "window_ms": window_ms,
           "idle_share": 1.0 - busy_ms / window_ms}
    print(json.dumps({"fft": fft, "hop": hop, "n_iter": n_iter,
                      "clips": batch, "frames": mag.shape[-1],
                      "busy_ms_per_call": busy_ms,
                      "window_ms_per_call": window_ms,
                      "idle_share": out["idle_share"], "card": name}),
          flush=True)
    return out


if __name__ == "__main__":
    run(*(int(a) for a in sys.argv[1:3]))
