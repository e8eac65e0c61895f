"""Pitch shifting.

Port of ``torchaudio_contrib_tpu/ops/pitch.py``: stretch time by
``2^(n/12)`` at constant pitch with the phase vocoder, then resample back
to the original length, which shifts the pitch by ``n`` semitones at
constant duration.
"""
from __future__ import annotations

from fractions import Fraction

import torch
import torch.nn.functional as F

from .stft import stft as _stft, istft as _istft
from .phase_vocoder import phase_vocoder, compute_phase_advance
from .resample import resample as _resample

__all__ = ["pitch_shift"]


def pitch_shift(waveform: torch.Tensor,
                sample_rate: int,
                n_steps: float,
                bins_per_octave: int = 12,
                fft_length: int = 512,
                hop_length: int = 128,
                window="hann") -> torch.Tensor:
    """Shift ``waveform (..., time)`` by ``n_steps`` semitones (fractional
    or negative too), keeping its duration.

    The shift ratio is approximated by a small rational so that the
    resampler stays a compact polyphase filter; the output has the input's
    length.  ``sample_rate`` is part of the signature only: the shift is a
    ratio.
    """
    del sample_rate
    if n_steps == 0:
        return waveform
    t = waveform.shape[-1]
    ratio = 2.0 ** (n_steps / bins_per_octave)
    frac = Fraction(ratio).limit_denominator(64)
    p, q = frac.numerator, frac.denominator

    # 1) time-stretch by 1/ratio at constant pitch: rate q/p
    spec = _stft(waveform, fft_length, hop_length, window=window)
    adv = compute_phase_advance(spec.shape[-2], hop_length, fft_length,
                                device=spec.device)
    stretched = phase_vocoder(spec, float(q) / p, adv)
    y = _istft(stretched, hop_length, window=window, fft_length=fft_length)
    # 2) resample by q/p: restores the duration, scales the pitch by p/q
    z = _resample(y, orig_freq=p, new_freq=q)
    if z.shape[-1] >= t:
        return z[..., :t]
    return F.pad(z, (0, t - z.shape[-1]))
