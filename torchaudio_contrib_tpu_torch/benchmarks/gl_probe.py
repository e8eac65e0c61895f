"""Fused Griffin-Lim layout probe: tile-major state against row-major.

    python -m torchaudio_contrib_tpu_torch.benchmarks.gl_probe

Counterpart of the JAX package's ``benchmarks/r4_gl_probe.py``: the state
as ``(ft, frames, 2·FBT)`` (every per-tile access indexes a leading dim)
against ``(frames, ft·2·FBT)``.  Both run the same kernels with other
strides, back to back in one process on one card, on the same input, and
must give the same waveform.  Prints JSON lines.  Needs a CUDA card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import card, time_cuda_ms
from ..ops.fused_griffinlim import _gl_fused, fused_gl_supported
from ..ops.stft import stft


def run(fft: int, hop: int, seconds: float, n_iter: int = 32,
        batch: int = 8, seed: int = 0) -> dict:
    """Times both layouts at ``batch`` clips of ``seconds`` at 22.05 kHz;
    returns ``{"baseline": ms, "tile_major": ms, "speedup", "rel_err"}``."""
    name = card()
    n = int(22050 * seconds)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, n)).astype(np.float32)).cuda()
    mag = stft(x, fft, hop, center=True).abs()
    if not fused_gl_supported(fft, hop, mag.shape[-1]):
        raise ValueError(f"fft={fft} hop={hop} is outside the kernels' rule")
    results = {}
    for layout, tile_major in (("baseline", False), ("tile_major", True)):
        ms = time_cuda_ms(lambda: _gl_fused(mag, fft, hop, "hann", n_iter,
                                            0.99, n, True,
                                            tile_major=tile_major))
        results[layout] = ms
        print(json.dumps({"metric": f"gl-fft{fft}-{layout}", "ms": ms,
                          "card": name}), flush=True)
    # the same math in another layout gives the same waveform
    ya = _gl_fused(mag, fft, hop, "hann", 8, 0.99, n, True)
    yb = _gl_fused(mag, fft, hop, "hann", 8, 0.99, n, True, tile_major=True)
    results["rel_err"] = float((ya - yb).abs().max()
                               / (ya.abs().max() + 1e-12))
    results["speedup"] = results["baseline"] / results["tile_major"]
    print(json.dumps({"metric": f"gl-fft{fft}-summary",
                      "speedup": results["speedup"],
                      "rel_err": results["rel_err"], "card": name}),
          flush=True)
    return results


def main() -> None:
    run(1024, 256, 5.0)
    run(2048, 512, 5.0)


if __name__ == "__main__":
    main()
