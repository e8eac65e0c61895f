"""Bisect the fused Griffin-Lim solve's cost by stage.

    python -m torchaudio_contrib_tpu_torch.benchmarks.gl_bisect \
        [fft|dft] [variant ...]

Counterpart of the JAX package's ``benchmarks/r3_gl_bisect.py``, at its
shape (fft 2048, hop 512, 8 x 110 250 samples, 32 iterations).  Times the
solve of ``csrc/fused_gl.cu`` with one stage switched off per variant, by
CUDA events, on the route the size takes (the shared-memory FFT kernels
at this shape) or on the one named first (``dft``: the DFT-product
kernels); the results are WRONG for every variant except ``full``:

  full    the kernels as :func:`~..ops.griffinlim.griffin_lim` runs them
  nonorm  momentum step and magnitude projection replaced by a plain copy
  noola   overlap-add, envelope and the write of the signal skipped
  nosyn   the synthesis transform skipped
  noana   the analysis transform skipped (its epilogue runs on zero sums)

``full`` minus a variant attributes that stage's cost.  Prints one JSON
line per variant.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import card, time_cuda_ms
from ..ops import fused_griffinlim as fg
from ..ops.fused import _route_for
from ..ops.stft import stft

FFT, HOP, N_ITER, MOMENTUM = 2048, 512, 32, 0.99
BATCH, SAMPLES = 8, 110250


def run(variants=fg.VARIANTS, fft_length: int = FFT, hop_length: int = HOP,
        n_iter: int = N_ITER, batch: int = BATCH, samples: int = SAMPLES,
        seed: int = 0, route=None, iters: int = 7) -> dict:
    """``{variant: ms}`` (the median of ``iters`` solves) on the card, on
    ``route`` (``"fft"``, ``"dft"``, or None for the one the size takes);
    prints a JSON line per variant."""
    name = card()
    route = _route_for(fft_length, route)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, samples)).astype(np.float32)).cuda()
    mag = stft(x, fft_length, hop_length).abs()
    ops = fg._gl_prepare(mag, fft_length, hop_length, "hann",
                         route=route)[:5]
    out = {}
    for variant in variants:
        ms = time_cuda_ms(lambda: fg._gl_solve_cuda(
            *ops, fft_length, hop_length, n_iter, MOMENTUM, False, variant,
            _route=route), 2, iters)
        out[variant] = ms
        print(json.dumps({"variant": variant, "route": route, "kernel_ms": ms,
                          "fft": fft_length, "hop": hop_length,
                          "n_iter": n_iter, "clips": batch,
                          "frames": mag.shape[-1], "card": name}),
              flush=True)
    return out


if __name__ == "__main__":
    named = sys.argv[1:2] if sys.argv[1:2] in (["fft"], ["dft"]) else []
    run(tuple(sys.argv[1 + len(named):]) or fg.VARIANTS,
        route=named[0] if named else None)
