"""Mel-scale conversion, mel filterbank construction, filterbank application.

Port of ``torchaudio_contrib_tpu/ops/filters.py`` (mel, linear and bark
filterbanks, and the torchaudio-named ``*_fbanks`` factories).
Filterbank matrices are built in float64 NumPy and cast to float32 at the edge;
``apply_filterbank`` is one einsum in full float32.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

__all__ = [
    "hertz_to_mel",
    "mel_to_hertz",
    "hertz_to_bark",
    "bark_to_hertz",
    "create_mel_filter",
    "create_linear_filter",
    "create_bark_filter",
    "melscale_fbanks",
    "linear_fbanks",
    "barkscale_fbanks",
    "apply_filterbank",
]

_ArrayLike = Union[float, np.ndarray, torch.Tensor]

_SLANEY_F_SP = 200.0 / 3.0               # Hz per mel below 1 kHz
_SLANEY_LOGSTEP = np.log(6.4) / 27.0     # above 1 kHz


def hertz_to_mel(freq: _ArrayLike, mel_scale: str = "htk") -> _ArrayLike:
    """HTK mel scale ``2595·log10(1 + f/700)``, or ``mel_scale="slaney"``
    for the librosa/Slaney-toolbox scale (linear below 1 kHz, log above).
    Tensors stay tensors; anything else is computed in float64 NumPy."""
    if mel_scale not in ("htk", "slaney"):
        raise ValueError("mel_scale must be 'htk' or 'slaney'")
    if isinstance(freq, torch.Tensor):
        if mel_scale == "htk":
            return 2595.0 * torch.log10(1.0 + freq / 700.0)
        return torch.where(
            freq >= 1000.0,
            15.0 + torch.log(torch.clamp(freq, min=1e-10) / 1000.0)
            / _SLANEY_LOGSTEP,
            freq / _SLANEY_F_SP)
    f = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / _SLANEY_LOGSTEP,
                    f / _SLANEY_F_SP)


def mel_to_hertz(mel: _ArrayLike, mel_scale: str = "htk") -> _ArrayLike:
    """Inverse HTK mel scale ``700·(10^(m/2595) − 1)``, or the inverse
    Slaney scale with ``mel_scale="slaney"``."""
    if mel_scale not in ("htk", "slaney"):
        raise ValueError("mel_scale must be 'htk' or 'slaney'")
    if isinstance(mel, torch.Tensor):
        if mel_scale == "htk":
            return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
        return torch.where(mel >= 15.0,
                           1000.0 * torch.exp(_SLANEY_LOGSTEP * (mel - 15.0)),
                           _SLANEY_F_SP * mel)
    m = np.asarray(mel, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(_SLANEY_LOGSTEP * (m - 15.0)),
                    _SLANEY_F_SP * m)


@functools.lru_cache(maxsize=32)
def _mel_filter_np(num_mels: int, sample_rate: float, f_min: float,
                   f_max: float, num_bins: int,
                   mel_scale: str = "htk",
                   norm: Optional[str] = None) -> np.ndarray:
    """Float64 triangular mel filterbank ``(num_bins, num_mels)``.

    Linear-frequency bin centers ``linspace(0, sr/2, num_bins)``; triangle
    corners linearly spaced on the chosen mel scale between
    ``f_min``/``f_max``.  HTK scale with no area normalization by default;
    ``mel_scale="slaney"`` / ``norm="slaney"`` give librosa's default.
    """
    all_freqs = np.linspace(0.0, sample_rate / 2.0, num_bins)
    m_min = float(hertz_to_mel(f_min, mel_scale))
    m_max = float(hertz_to_mel(f_max, mel_scale))
    m_pts = np.linspace(m_min, m_max, num_mels + 2)
    f_pts = np.asarray(mel_to_hertz(m_pts, mel_scale), dtype=np.float64)

    f_diff = f_pts[1:] - f_pts[:-1]                        # (num_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]           # (num_bins, num_mels+2)
    down = -slopes[:, :-2] / f_diff[None, :-1]             # rising edge
    up = slopes[:, 2:] / f_diff[None, 1:]                  # falling edge
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    elif norm is not None:
        raise ValueError("norm must be None or 'slaney'")
    return fb


def create_mel_filter(num_mels: int = 128,
                      sample_rate: float = 22050,
                      f_min: float = 0.0,
                      f_max: Optional[float] = None,
                      num_bins: int = 1025,
                      mel_scale: str = "htk",
                      norm: Optional[str] = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """Mel filterbank matrix ``(num_bins, num_mels)``.

    ``num_bins`` is the number of one-sided FFT bins (``fft_length//2+1``).
    ``f_max`` defaults to the Nyquist frequency.
    """
    if f_max is None:
        f_max = sample_rate / 2.0
    fb = _mel_filter_np(int(num_mels), float(sample_rate), float(f_min),
                        float(f_max), int(num_bins), str(mel_scale), norm)
    return torch.as_tensor(fb, dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _linear_filter_np(n_filter: int, sample_rate: float, f_min: float,
                      f_max: float, num_bins: int) -> np.ndarray:
    """Float64 triangular filterbank with corners linearly spaced in Hz
    ``(num_bins, n_filter)`` (torchaudio's ``linear_fbanks``
    construction, the LFCC front end)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, num_bins)
    f_pts = np.linspace(f_min, f_max, n_filter + 2)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


def create_linear_filter(n_filter: int = 128,
                         sample_rate: float = 22050,
                         f_min: float = 0.0,
                         f_max: Optional[float] = None,
                         num_bins: int = 1025,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """Linear-frequency triangular filterbank ``(num_bins, n_filter)``.

    Same contract as :func:`create_mel_filter`, with corners spaced
    linearly in Hz instead of on the mel scale; the fused kernels take it
    like any filterbank matrix.
    """
    if f_max is None:
        f_max = sample_rate / 2.0
    fb = _linear_filter_np(int(n_filter), float(sample_rate), float(f_min),
                           float(f_max), int(num_bins))
    return torch.as_tensor(fb, dtype=dtype, device=device)


def apply_filterbank(mag_specgrams: torch.Tensor,
                     filterbank: torch.Tensor) -> torch.Tensor:
    """Project ``(..., freq, time)`` magnitudes through ``(freq, num_mels)``.

    Returns ``(..., num_mels, time)``: one einsum over the frequency axis.
    In float32 it is a full-precision product as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (its default).
    """
    return torch.einsum("...ft,fm->...mt", mag_specgrams, filterbank)


def _bark_lib(x):
    """``(values, module)``: tensors stay tensors (``torch``), anything
    else is computed in float64 NumPy."""
    if isinstance(x, torch.Tensor):
        return x, torch
    return np.asarray(x, dtype=np.float64), np


def hertz_to_bark(freq: _ArrayLike, bark_scale: str = "traunmuller"):
    """Hz → Bark.  ``bark_scale`` is ``traunmuller``, ``schroeder`` or
    ``wang`` (the three conventions of torchaudio's
    ``barkscale_fbanks``)."""
    f, xp = _bark_lib(freq)
    if bark_scale == "schroeder":
        return 7.0 * xp.arcsinh(f / 650.0)
    if bark_scale == "wang":
        return 6.0 * xp.arcsinh(f / 600.0)
    if bark_scale != "traunmuller":
        raise ValueError(f"unknown bark_scale {bark_scale!r}")
    b = 26.81 * f / (1960.0 + f) - 0.53
    b = xp.where(b < 2.0, b + 0.15 * (2.0 - b), b)
    return xp.where(b > 20.1, b + 0.22 * (b - 20.1), b)


def bark_to_hertz(bark: _ArrayLike, bark_scale: str = "traunmuller"):
    """Bark → Hz (inverse of :func:`hertz_to_bark`)."""
    b, xp = _bark_lib(bark)
    if bark_scale == "schroeder":
        return 650.0 * xp.sinh(b / 7.0)
    if bark_scale == "wang":
        return 600.0 * xp.sinh(b / 6.0)
    if bark_scale != "traunmuller":
        raise ValueError(f"unknown bark_scale {bark_scale!r}")
    b = xp.where(b < 2.0, (b - 0.3) / 0.85, b)
    b = xp.where(b > 20.1, (b + 4.422) / 1.22, b)
    return 1960.0 * (b + 0.53) / (26.28 - b)


@functools.lru_cache(maxsize=32)
def _bark_filter_np(n_barks: int, sample_rate: float, f_min: float,
                    f_max: float, num_bins: int,
                    bark_scale: str) -> np.ndarray:
    """Float64 triangular bark filterbank ``(num_bins, n_barks)``: corners
    linearly spaced on the chosen bark scale, triangles linear in Hz
    between corners (the mel builder's construction)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, num_bins)
    b_pts = np.linspace(float(hertz_to_bark(f_min, bark_scale)),
                        float(hertz_to_bark(f_max, bark_scale)),
                        n_barks + 2)
    f_pts = np.asarray(bark_to_hertz(b_pts, bark_scale), np.float64)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


def create_bark_filter(n_barks: int = 128,
                       sample_rate: float = 22050,
                       f_min: float = 0.0,
                       f_max: Optional[float] = None,
                       num_bins: int = 1025,
                       bark_scale: str = "traunmuller",
                       dtype: torch.dtype = torch.float32,
                       device=None) -> torch.Tensor:
    """Bark filterbank matrix ``(num_bins, n_barks)``; same contract as
    :func:`create_mel_filter`."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fb = _bark_filter_np(int(n_barks), float(sample_rate), float(f_min),
                         float(f_max), int(num_bins), bark_scale)
    return torch.as_tensor(fb, dtype=dtype, device=device)


# torchaudio-style names (argument order of torchaudio's
# functional.*_fbanks; the same matrices as the create_* builders)
def melscale_fbanks(n_freqs: int, f_min: float, f_max: float,
                    n_mels: int, sample_rate: float,
                    norm: Optional[str] = None,
                    mel_scale: str = "htk") -> torch.Tensor:
    """torchaudio's ``melscale_fbanks`` surface over
    :func:`create_mel_filter`: ``(n_freqs, n_mels)``."""
    return create_mel_filter(n_mels, sample_rate, f_min, f_max, n_freqs,
                             mel_scale=mel_scale, norm=norm)


def linear_fbanks(n_freqs: int, f_min: float, f_max: float,
                  n_filter: int, sample_rate: float) -> torch.Tensor:
    """torchaudio's ``linear_fbanks`` surface over
    :func:`create_linear_filter`."""
    return create_linear_filter(n_filter, sample_rate, f_min, f_max, n_freqs)


def barkscale_fbanks(n_freqs: int, f_min: float, f_max: float,
                     n_barks: int, sample_rate: float,
                     bark_scale: str = "traunmuller") -> torch.Tensor:
    """torchaudio's ``barkscale_fbanks`` surface over
    :func:`create_bark_filter`."""
    return create_bark_filter(n_barks, sample_rate, f_min, f_max, n_freqs,
                              bark_scale=bark_scale)
