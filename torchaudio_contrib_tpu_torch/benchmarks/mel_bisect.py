"""What the fused mel kernels' time is made of, at config 2.

    python -m torchaudio_contrib_tpu_torch.benchmarks.mel_bisect

Times, by CUDA events at 32 x 30 s (22.05 kHz, fft 2048, hop 512), the
FFT-route forward kernel without and with its residual, and the backward's
frame passes and filterbank pass, for 64, 128, 256 and 512 mels.  The mel
products grow with the number of mels and the transform does not, so a
line through the times splits each kernel: the intercept is the transform
with its loads, stores and bin arithmetic, the slope the mel product per 64
mels.  Prints one JSON line per number of mels and one with the fitted
intercepts and slopes.  Needs a CUDA card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import card, time_cuda_ms
from ..ops import fused

MELS = (64, 128, 256, 512)


def run(seed: int = 0, route=None) -> dict:
    """``{"rows": [...], "fit": {kernel: (intercept ms, ms per 64 mels)}}``."""
    name = card()
    rng = np.random.default_rng(seed)
    fft, hop = 2048, 512
    x = torch.from_numpy(rng.standard_normal(
        (32, 30 * 22050)).astype(np.float32)).cuda()
    args = (fft, hop, "hann", None, True, 1.0, 1e-7)
    rows = []
    with torch.no_grad():
        for mels in MELS:
            fb = torch.from_numpy(rng.random(
                (fft // 2 + 1, mels)).astype(np.float32)).cuda()
            _, reim = fused._fused_mel_fwd_cuda(x, fb, *args, save_spec=True,
                                                _route=route)
            reim = reim.reshape(-1, reim.shape[-1])
            dmel = torch.from_numpy(rng.standard_normal(
                (reim.shape[0], mels)).astype(np.float32)).cuda()

            def fwd(save_spec):
                return fused._fused_mel_fwd_cuda(x, fb, *args,
                                                 save_spec=save_spec,
                                                 _route=route)

            def bwd(need_dx, need_dfb):
                return fused._fused_mel_bwd_cuda(dmel, reim, fb, fft, "hann",
                                                 None, need_dx, need_dfb,
                                                 _route=route)

            row = {"mels": mels,
                   "forward_ms": time_cuda_ms(lambda: fwd(False), 2, 9),
                   "forward_residual_ms": time_cuda_ms(lambda: fwd(True),
                                                       2, 9),
                   "frame_passes_ms": time_cuda_ms(lambda: bwd(True, False),
                                                   2, 9),
                   "dfb_pass_ms": time_cuda_ms(lambda: bwd(False, True),
                                               2, 9),
                   "card": name}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del reim, dmel
    units = np.array(MELS) / 64.0
    fit = {}
    for key in ("forward_ms", "forward_residual_ms", "frame_passes_ms",
                "dfb_pass_ms"):
        slope, intercept = np.polyfit(units, [r[key] for r in rows], 1)
        fit[key] = (float(intercept), float(slope))
    print(json.dumps({"fit_intercept_ms_and_ms_per_64_mels": fit,
                      "card": name}), flush=True)
    return {"rows": rows, "fit": fit}


if __name__ == "__main__":
    run()
