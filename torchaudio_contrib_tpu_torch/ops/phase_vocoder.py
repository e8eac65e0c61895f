"""Phase vocoder: time-stretch a complex spectrogram without pitch shift.

Port of ``torchaudio_contrib_tpu/ops/phase_vocoder.py``.  The fractional
frame positions are computed in float64 NumPy from the static ``rate``;
the phase accumulation, the only sequentially dependent step, is one
``torch.cumsum`` in float64 (the JAX package sums in float32; on a long
clip that sum's rounding, not the signal, decides the phases).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["phase_vocoder", "compute_phase_advance"]


def compute_phase_advance(n_freqs: int, hop_length: int,
                          fft_length: Optional[int] = None,
                          device=None) -> torch.Tensor:
    """Expected per-frame phase advance per onesided bin, ``hop·2πf/N``, of
    shape ``(n_freqs, 1)`` to broadcast over ``(..., freq, time)``."""
    if fft_length is None:
        fft_length = 2 * (n_freqs - 1)
    adv = (2.0 * np.pi * hop_length
           * np.arange(n_freqs, dtype=np.float64) / fft_length)
    return torch.as_tensor(adv[:, None], dtype=torch.float32, device=device)


def phase_vocoder(complex_specgrams: torch.Tensor, rate: float,
                  phase_advance: torch.Tensor) -> torch.Tensor:
    """Stretch complex ``(..., freq, time)`` in time by ``rate``.

    ``rate > 1`` speeds up (fewer output frames); ``rate < 1`` slows down.
    Magnitudes are linearly interpolated at fractional frame positions;
    phases advance by the unwrapped instantaneous frequency, accumulated
    with a cumulative sum.  Output has ``ceil(time / rate)`` frames.
    """
    if rate == 1.0:
        return complex_specgrams

    n_time = complex_specgrams.shape[-1]
    device = complex_specgrams.device
    time_steps = np.arange(0, n_time, rate, dtype=np.float64)
    idx0_np = time_steps.astype(np.int64)
    idx0 = torch.as_tensor(idx0_np, device=device)
    alphas = torch.as_tensor((time_steps - idx0_np)[None, :],
                             dtype=torch.float32, device=device)

    # two zero frames so idx0 + 1 stays in range
    spec = F.pad(complex_specgrams, (0, 2))
    s0 = spec[..., idx0]
    s1 = spec[..., idx0 + 1]
    norm0, norm1 = torch.abs(s0), torch.abs(s1)
    angle0, angle1 = torch.angle(s0), torch.angle(s1)

    phase_advance = torch.as_tensor(phase_advance, dtype=angle0.dtype,
                                    device=device)
    # unwrapped instantaneous frequency between consecutive source frames
    dphase = angle1 - angle0 - phase_advance
    dphase = dphase - 2.0 * math.pi * torch.round(dphase / (2.0 * math.pi))
    dphase = dphase + phase_advance

    # seeded with the first frame's phase; summed in float64 and wrapped
    # into [0, 2π) before the trigonometry: a float32 running sum reaches
    # ~1e5 rad at the top bins of a 10 s clip, where its ulp is ~0.01 rad,
    # and the card's and the CPU's summation orders then land up to 0.4 of
    # peak apart (chip_smoke.py phase 25 (c))
    phase = torch.cat([angle0[..., :1], dphase[..., :-1]], dim=-1)
    phase_acc = torch.remainder(torch.cumsum(phase.double(), dim=-1),
                                2.0 * math.pi).to(phase.dtype)

    mag = alphas * norm1 + (1.0 - alphas) * norm0
    return torch.complex(mag * torch.cos(phase_acc),
                         mag * torch.sin(phase_acc))
