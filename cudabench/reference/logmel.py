"""Plain log-mel spectrogram: ``torch.stft`` with a periodic Hann window
and ``center=False`` -> ``|.|^2`` -> mel product -> dB.

Written from the construction the measured package documents (an HTK mel
scale, triangles over linearly spaced bins, no area normalisation; dB as
``10 log10(max(mel, amin)) - 10 log10(max(amin, ref))``), and frozen here
so that a change to the program cannot change what it is held to.  It
imports nothing of the program.  Every function runs in the dtype of its
input: float64 for the reference, float32 under ``tf32(True)`` for the
lower-precision control.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS and cuDNN float32 products in TF32 (``on``) or in FP32, and
    the flags as they were afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(num_mels: int, sample_rate: float, n_freqs: int,
                   f_min: float = 0.0, f_max: float | None = None):
    """``(n_freqs, num_mels)`` float64 NumPy: triangles whose corners are
    evenly spaced on the HTK mel scale from ``f_min`` to ``f_max``
    (Nyquist by default), sampled at ``linspace(0, sr/2, n_freqs)``."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    bins = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    corners = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                    num_mels + 2))
    fb = np.zeros((n_freqs, num_mels))
    for m in range(num_mels):
        lo, mid, hi = corners[m], corners[m + 1], corners[m + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return fb


def hann(n: int, like: torch.Tensor) -> torch.Tensor:
    """Periodic Hann window of ``n`` samples, as ``like``."""
    k = torch.arange(n, dtype=torch.float64, device=like.device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).to(like.dtype)


def logmel(x: torch.Tensor, fb: torch.Tensor, fft_length: int,
           hop_length: int, to_db: bool = True, db_ref: float = 1.0,
           amin: float = 1e-7) -> torch.Tensor:
    """``x (..., T)`` -> ``(..., mels, frames)`` with ``fb (n_freqs,
    mels)``, differentiable in both."""
    lead, n = x.shape[:-1], x.shape[-1]
    spec = torch.stft(x.reshape(-1, n), fft_length, hop_length,
                      window=hann(fft_length, x), center=False,
                      onesided=True, return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2            # (S, F, frames)
    mel = torch.matmul(power.transpose(1, 2), fb).transpose(1, 2)
    if to_db:
        mel = (10.0 * torch.log10(torch.clamp(mel, min=amin))
               - 10.0 * math.log10(max(amin, db_ref)))
    return mel.reshape(lead + mel.shape[1:])
