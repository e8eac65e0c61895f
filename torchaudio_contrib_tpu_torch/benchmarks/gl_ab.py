"""Times of the fused Griffin-Lim solve, for comparing two trees.

    PYTHONPATH=<tree> python <tree>/torchaudio_contrib_tpu_torch/benchmarks/gl_ab.py

(run as a file: ``python -m`` would put the working directory's package
first).  Prints one JSON line: the tree the package was imported from,
then, by CUDA events at the Griffin-Lim benchmark's shapes (8 x 110 250
samples, 32 iterations; fft 1024 / hop 256 and fft 2048 / hop 512), medians
of 9 solves each: the FFT-route kernels in both layouts, twice each, each
stage-bisect variant, the DFT-product kernels, and the whole op.  To compare a change with its parent on one card, unpack
the parent beside the change and run parent, change, change, parent in one
command; the run-to-run spread of one tree is the yardstick.  Needs a CUDA
card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

import torchaudio_contrib_tpu_torch as package
from torchaudio_contrib_tpu_torch import ops
from torchaudio_contrib_tpu_torch.benchmarks import card, time_cuda_ms
from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg

SHAPES = ((1024, 256), (2048, 512))
N_ITER, MOMENTUM, BATCH, SAMPLES = 32, 0.99, 8, 110250


def run(seed: int = 0) -> dict:
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (BATCH, SAMPLES)).astype(np.float32)).cuda()
    out = {"tree": package.__file__, "card": card()}
    with torch.inference_mode():
        for fft, hop in SHAPES:
            mag = ops.stft(x, fft, hop).abs()

            def solve(prep, route, tile_major=False, variant="full"):
                return time_cuda_ms(lambda: fg._gl_solve_cuda(
                    *prep, fft, hop, N_ITER, MOMENTUM, tile_major, variant,
                    _route=route), 2, 9)

            for turn in range(2):
                for tile_major in (False, True):
                    lay = "tile_major" if tile_major else "row_major"
                    prep = fg._gl_prepare(mag, fft, hop, "hann", None,
                                          tile_major, "fft")[:5]
                    out[f"fft{fft}_{lay}_ms_{turn}"] = solve(prep, "fft",
                                                             tile_major)
            for variant in fg.VARIANTS[1:]:
                out[f"fft{fft}_{variant}_ms"] = solve(prep, "fft", True,
                                                      variant)
            prep = fg._gl_prepare(mag, fft, hop, "hann")[:5]
            out[f"fft{fft}_dft_route_ms"] = solve(prep, "dft")
            out[f"fft{fft}_whole_op_ms"] = time_cuda_ms(
                lambda: ops.griffin_lim(mag, fft, hop, n_iter=N_ITER,
                                        momentum=MOMENTUM, length=SAMPLES,
                                        method="pallas"), 2, 9)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
