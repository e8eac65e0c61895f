"""Where one fused Griffin-Lim call spends the card's time.

    python -m torchaudio_contrib_tpu_torch.benchmarks.gl_profile \
        [fft hop [fft|dft]]

Traces ``calls`` whole calls of the fused Griffin-Lim (operand set-up, the
solve of ``csrc/fused_gl.cu`` on the route the size takes or on the one
named, the final inverse transform) with
``torch.profiler`` after two warm-ups, at the Griffin-Lim benchmark's shape
(8 x 110 250 samples, 32 iterations; fft 1024 / hop 256 unless given), and
prints one JSON line per device kernel (ms and launches per call, share of
the busy time) and a summary line: the route, busy ms per call, the host-clock ms per
call of the traced window, and the idle share ``1 − busy / window`` (the
window includes the profiler's own overhead).  Needs a CUDA card.
"""
from __future__ import annotations

from functools import partial
import sys

import numpy as np
import torch

from . import trace_kernels
from ..ops.fused import _route_for
from ..ops.fused_griffinlim import _gl_run, _gl_solve_cuda
from ..ops.stft import stft


def run(fft: int = 1024, hop: int = 256, n_iter: int = 32, batch: int = 8,
        samples: int = 110250, calls: int = 3, seed: int = 0,
        route=None) -> dict:
    """``{"kernels": {name: (ms, launches) per call}, "busy_ms", "window_ms",
    "idle_share"}``; prints the JSON lines.  ``route`` None is the route
    the size takes, as ``griffin_lim(method="pallas")`` runs it."""
    route = _route_for(fft, route)
    solve = partial(_gl_solve_cuda, _route=route)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, samples)).astype(np.float32)).cuda()
    mag = stft(x, fft, hop).abs()
    return trace_kernels(
        lambda: _gl_run(solve, route, mag, fft, hop, "hann", n_iter, 0.99,
                        samples, True, None, False),
        calls, fft=fft, hop=hop, route=route, n_iter=n_iter, clips=batch,
        frames=mag.shape[-1])


if __name__ == "__main__":
    run(*(int(a) for a in sys.argv[1:3]), route=(sys.argv[3:4] or [None])[0])
