"""Where the fused mel front end spends the card's time.

    python -m torchaudio_contrib_tpu_torch.benchmarks.mel_profile [route]

Traces, with ``torch.profiler`` after two warm-ups, at full width: the
forward of config 2 (32 x 30 s at 22.05 kHz, fft 2048, hop 512, 128 mels)
under ``torch.inference_mode()``; its forward + backward with waveform and
filterbank gradients; one train step of config 3 (32 x 10 s at 16 kHz, fft
512, hop 128, 64 mels into the CNN).  Prints one JSON line for each of the
14 longest device kernels (ms and launches per call, share of the busy
time) and a summary line per part with the peak device memory.  ``route`` (``fft`` or ``dft``)
names the kernels config 2 goes through; without it the size decides (the
FFT kernels).  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from . import trace_kernels
from ..models import MelFrontendClassifier
from ..ops import create_mel_filter, fused


def run(route=None, calls: int = 3, seed: int = 0) -> dict:
    """The three traces as ``{"forward", "fwd_bwd", "config3_step"}``."""
    rng = np.random.default_rng(seed)
    fft, hop, mels = 2048, 512, 128
    x = torch.from_numpy(rng.standard_normal(
        (32, 1, 30 * 22050)).astype(np.float32)).cuda()
    fb = create_mel_filter(mels, 22050, 0.0, None, fft // 2 + 1,
                           device="cuda")
    frames = 1 + (x.shape[-1] - fft) // hop
    g = torch.from_numpy(rng.standard_normal(
        (32, 1, mels, frames)).astype(np.float32)).cuda()

    def op(xv, fbv):
        return fused._fused_apply(
            xv, fbv, fft, hop, "hann", None, True, 1.0, 1e-7,
            partial(fused._fused_mel_fwd_cuda, _route=route),
            partial(fused._fused_mel_bwd_cuda, _route=route))

    def forward():
        with torch.inference_mode():
            return op(x, fb)

    xg, fbg = x.clone().requires_grad_(), fb.clone().requires_grad_()

    def fwd_bwd():
        return torch.autograd.grad(op(xg, fbg), (xg, fbg), g)

    model = MelFrontendClassifier(
        num_classes=10, num_mels=64, sample_rate=16000, fft_length=512,
        hop_length=128, fused=True, trainable_frontend=True,
        generator=torch.Generator().manual_seed(1)).cuda()
    xb = torch.from_numpy(rng.standard_normal(
        (32, 1, 160000)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 32)).cuda()

    out = {}
    for name, call in (("forward", forward), ("fwd_bwd", fwd_bwd),
                       ("config3_step",
                        lambda: model.train_step(xb, labels, 0.0))):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        out[name] = trace_kernels(call, calls, top=14, part=name,
                                  route=route or "by size",
                                  peak_mib_above_inputs=peak)
    return out


if __name__ == "__main__":
    run(*sys.argv[1:2])
