"""Spectral shape descriptors.

Port of ``torchaudio_contrib_tpu/ops/spectral.py``: reductions over the
frequency axis of a magnitude spectrogram.  Every function takes ``(...,
freq, time)`` magnitudes (power 1) and the bin-to-Hz mapping that
``sample_rate`` implies, and returns ``(..., time)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "spectral_centroid",
    "spectral_bandwidth",
    "spectral_rolloff",
    "spectral_flatness",
    "zero_crossing_rate",
]


def _bin_freqs(n_freqs: int, sample_rate: float, like: torch.Tensor):
    """Centre frequency of each onesided bin, ``(n_freqs,)`` Hz."""
    return torch.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=like.dtype,
                          device=like.device)


def spectral_centroid(mag_specgrams: torch.Tensor,
                      sample_rate: float) -> torch.Tensor:
    """Magnitude-weighted mean frequency per frame, in Hz; silent frames
    give 0, not NaN."""
    f = _bin_freqs(mag_specgrams.shape[-2], sample_rate, mag_specgrams)
    num = torch.einsum("...ft,f->...t", mag_specgrams, f)
    den = mag_specgrams.sum(dim=-2)
    return num / torch.clamp(den, min=1e-20)


def spectral_bandwidth(mag_specgrams: torch.Tensor, sample_rate: float,
                       p: float = 2.0) -> torch.Tensor:
    """p-th-order magnitude-weighted spread around the centroid, Hz."""
    f = _bin_freqs(mag_specgrams.shape[-2], sample_rate, mag_specgrams)
    cent = spectral_centroid(mag_specgrams, sample_rate)
    dev = torch.abs(f[:, None] - cent[..., None, :]) ** p
    num = (mag_specgrams * dev).sum(dim=-2)
    den = torch.clamp(mag_specgrams.sum(dim=-2), min=1e-20)
    return (num / den) ** (1.0 / p)


def spectral_rolloff(mag_specgrams: torch.Tensor, sample_rate: float,
                     roll_percent: float = 0.85) -> torch.Tensor:
    """Frequency below which ``roll_percent`` of the energy lies, Hz: the
    first bin whose cumulative energy reaches the threshold (piecewise
    constant, gradient 0)."""
    cum = torch.cumsum(mag_specgrams, dim=-2)
    reached = cum >= roll_percent * cum[..., -1:, :]
    idx = torch.argmax(reached.to(torch.uint8), dim=-2)
    f = _bin_freqs(mag_specgrams.shape[-2], sample_rate, mag_specgrams)
    return f[idx]


def spectral_flatness(mag_specgrams: torch.Tensor,
                      amin: float = 1e-10) -> torch.Tensor:
    """Geometric mean over arithmetic mean of the power spectrum, in (0, 1]
    (1 for white noise, towards 0 for a pure tone)."""
    p = torch.clamp(mag_specgrams, min=amin) ** 2
    return torch.exp(torch.log(p).mean(dim=-2)) / p.mean(dim=-2)


def zero_crossing_rate(waveform: torch.Tensor, frame_length: int = 2048,
                       hop_length: Optional[int] = None,
                       center: bool = True) -> torch.Tensor:
    """Fraction of sign changes per frame of ``waveform (..., T)`` →
    ``(..., n_frames)``; ``center=True`` zero-pads ``frame_length // 2`` on
    both sides."""
    from .stft import frame_signal, _pad_center

    if hop_length is None:
        hop_length = frame_length // 4
    x = waveform
    if center:
        x = _pad_center(x, frame_length // 2, "constant")
    crossings = (torch.signbit(x[..., 1:])
                 != torch.signbit(x[..., :-1])).to(torch.float32)
    crossings = F.pad(crossings, (1, 0))
    return frame_signal(crossings, frame_length, hop_length).mean(dim=-1)
