"""Approximate mel-spectrogram inversion.

Port of ``torchaudio_contrib_tpu/ops/melinv.py``: ``log-mel → mel → linear
magnitude → (griffin_lim) → waveform``.  The inversion is one precomputed
matrix applied as a matrix product: the regularised least-squares solve
happens once in float64 NumPy (mel matrices are tiny) and is cached.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .db import db_to_amplitude
from .filters import _mel_filter_np, _bark_filter_np
from .griffinlim import griffin_lim

__all__ = ["create_inverse_mel_filter", "create_inverse_bark_filter",
           "mel_to_linear", "mel_to_audio"]


def _ridge_inverse(fb: np.ndarray, ridge: float) -> np.ndarray:
    """``(banks, num_bins)`` minimiser of ``||fb·G − I||² + ridge·||G||²``
    for the ``(num_bins, banks)`` filterbank ``fb``, in float64.  Rows of
    ``fb`` outside every triangle (the DC and Nyquist edges) cannot be
    recovered and invert to ~0."""
    a = fb.T @ fb + ridge * np.eye(fb.shape[1])
    return np.linalg.solve(a, fb.T)


@functools.lru_cache(maxsize=16)
def _inverse_mel_np(num_mels: int, sample_rate: float, f_min: float,
                    f_max: float, num_bins: int, ridge: float) -> np.ndarray:
    return _ridge_inverse(_mel_filter_np(num_mels, sample_rate, f_min, f_max,
                                         num_bins), ridge)


@functools.lru_cache(maxsize=16)
def _inverse_bark_np(n_barks: int, sample_rate: float, f_min: float,
                     f_max: float, num_bins: int, bark_scale: str,
                     ridge: float) -> np.ndarray:
    return _ridge_inverse(_bark_filter_np(n_barks, sample_rate, f_min, f_max,
                                          num_bins, bark_scale), ridge)


def create_inverse_mel_filter(num_mels: int = 128,
                              sample_rate: float = 22050,
                              f_min: float = 0.0,
                              f_max: Optional[float] = None,
                              num_bins: int = 1025,
                              ridge: float = 1e-8,
                              dtype: torch.dtype = torch.float32,
                              device=None) -> torch.Tensor:
    """Inverse-projection matrix ``(num_mels, num_bins)`` for
    :func:`mel_to_linear`; parameters mirror ``create_mel_filter``."""
    if f_max is None:
        f_max = sample_rate / 2.0
    g = _inverse_mel_np(int(num_mels), float(sample_rate), float(f_min),
                        float(f_max), int(num_bins), float(ridge))
    return torch.as_tensor(g, dtype=dtype, device=device)


def create_inverse_bark_filter(n_barks: int = 128,
                               sample_rate: float = 22050,
                               f_min: float = 0.0,
                               f_max: Optional[float] = None,
                               num_bins: int = 1025,
                               bark_scale: str = "traunmuller",
                               ridge: float = 1e-8,
                               dtype: torch.dtype = torch.float32,
                               device=None) -> torch.Tensor:
    """Inverse-projection matrix ``(n_barks, num_bins)`` for
    :func:`mel_to_linear` (the projection is scale-agnostic); parameters
    mirror ``create_bark_filter``."""
    if f_max is None:
        f_max = sample_rate / 2.0
    g = _inverse_bark_np(int(n_barks), float(sample_rate), float(f_min),
                         float(f_max), int(num_bins), str(bark_scale),
                         float(ridge))
    return torch.as_tensor(g, dtype=dtype, device=device)


def mel_to_linear(mel_specgrams: torch.Tensor,
                  inverse_filterbank: torch.Tensor) -> torch.Tensor:
    """Project ``(..., num_mels, time)`` mel magnitudes back to
    ``(..., num_bins, time)`` linear-frequency magnitudes, clipped at 0:
    one einsum, like the forward projection."""
    out = torch.einsum("...mt,mf->...ft", mel_specgrams, inverse_filterbank)
    return torch.clamp(out, min=0.0)


def mel_to_audio(mel_specgrams: torch.Tensor,
                 num_mels: Optional[int] = None,
                 sample_rate: float = 22050,
                 f_min: float = 0.0,
                 f_max: Optional[float] = None,
                 fft_length: int = 2048,
                 hop_length: Optional[int] = None,
                 window="hann",
                 power: float = 2.0,
                 from_db: bool = False,
                 db_ref: float = 1.0,
                 n_iter: int = 32,
                 momentum: float = 0.99,
                 length: Optional[int] = None,
                 center: bool = True,
                 generator: Optional[torch.Generator] = None,
                 ridge: float = 1e-8,
                 method: str = "matmul") -> torch.Tensor:
    """Invert a (log-)mel spectrogram ``(..., num_mels, time)`` all the way
    to a waveform: [dB → power] → mel → linear (ridge pseudo-inverse) →
    magnitude → Griffin-Lim.

    The one-call composition of :func:`~.db.db_to_amplitude`,
    :func:`mel_to_linear` and :func:`~.griffinlim.griffin_lim`: the
    vocoder-style serving path for mel features made by
    ``Melspectrogram()`` or ``fused_melspectrogram`` (match
    ``power``/``from_db``/``db_ref`` to how the features were made;
    ``fused_melspectrogram(to_db=True)`` → ``power=2.0, from_db=True``).
    ``method`` selects the Griffin-Lim engine (``"matmul"`` by default;
    ``"pallas"`` for the fused kernels).  Returns ``(..., samples)``.
    """
    mel = mel_specgrams.to(torch.float32)
    if from_db:
        mel = db_to_amplitude(mel, ref=db_ref, power=power)
    if num_mels is None:
        num_mels = mel.shape[-2]
    inv = create_inverse_mel_filter(num_mels, sample_rate, f_min, f_max,
                                    fft_length // 2 + 1, ridge,
                                    device=mel.device)
    lin = mel_to_linear(mel, inv)
    mag = lin if power == 1.0 else lin ** (1.0 / power)
    if hop_length is None:
        hop_length = fft_length // 4
    return griffin_lim(mag, fft_length, hop_length, window=window,
                       n_iter=n_iter, momentum=momentum, length=length,
                       center=center, generator=generator, method=method)
