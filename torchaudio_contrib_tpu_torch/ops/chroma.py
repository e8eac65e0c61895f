"""Chroma (pitch-class) filterbank.

Port of ``torchaudio_contrib_tpu/ops/chroma.py``: the Gaussian-bump design
of Ellis' chroma toolbox as librosa adopted it.  Each FFT bin's centre
frequency is mapped to a fractional chroma coordinate on a circle of
``n_chroma`` classes, each class collects bins with a Gaussian window in
(wrapped) chroma distance, and an optional Gaussian octave weighting
centred on ``ctroct`` tames the extreme octaves.  Built in float64 NumPy
and cached; applied like the mel bank (:func:`~.filters.apply_filterbank`).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["create_chroma_filter", "chroma_filterbank"]


@functools.lru_cache(maxsize=32)
def _chroma_filter_np(n_chroma: int, sample_rate: float, num_bins: int,
                      tuning: float, ctroct: float,
                      octwidth: Optional[float], base_c: bool,
                      norm: Optional[int]) -> np.ndarray:
    # onesided bins: num_bins = n_fft//2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, num_bins)[1:]  # skip DC
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    # fractional chroma coordinate of each bin (octaves × n_chroma)
    frqbins = n_chroma * np.log2(freqs / (a440 / 16.0))
    frqbins = np.concatenate([[frqbins[0] - 1.5 * n_chroma], frqbins])
    binwidth = np.concatenate(
        [np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]])
    d = frqbins[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    half = n_chroma / 2.0
    d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2.0 * d / binwidth[None, :]) ** 2)
    if norm is not None:
        col = np.linalg.norm(wts, ord=norm, axis=0)
        wts = wts / np.where(col > 0, col, 1.0)
    if octwidth is not None:
        wts *= np.exp(
            -0.5 * ((frqbins / n_chroma - ctroct) / octwidth) ** 2)[None, :]
    if base_c:
        # rotate so that row 0 is pitch class C instead of A
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts.T)            # (num_bins, n_chroma)


def create_chroma_filter(n_chroma: int = 12, sample_rate: float = 22050,
                         num_bins: int = 1025, tuning: float = 0.0,
                         ctroct: float = 5.0,
                         octwidth: Optional[float] = 2.0,
                         base_c: bool = True,
                         norm: Optional[int] = 2,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """Chroma filterbank ``(num_bins, n_chroma)`` for onesided spectra
    (``num_bins = fft_length//2 + 1``).  ``base_c=True`` puts pitch class C
    in row 0 (librosa's convention), else A; ``octwidth=None`` drops the
    octave weighting."""
    if num_bins < 2:
        raise ValueError(f"num_bins must be >= 2, got {num_bins}")
    fb = _chroma_filter_np(int(n_chroma), float(sample_rate), int(num_bins),
                           float(tuning), float(ctroct),
                           None if octwidth is None else float(octwidth),
                           bool(base_c), norm)
    return torch.as_tensor(fb, dtype=dtype, device=device)


def chroma_filterbank(sample_rate: float, n_freqs: int, n_chroma: int, *,
                      tuning: float = 0.0, ctroct: float = 5.0,
                      octwidth: Optional[float] = 2.0,
                      norm: Optional[int] = 2,
                      base_c: bool = True) -> torch.Tensor:
    """torchaudio's argument order (``prototype.functional.
    chroma_filterbank``) for :func:`create_chroma_filter` → ``(n_freqs,
    n_chroma)``."""
    return create_chroma_filter(n_chroma, sample_rate, n_freqs,
                                tuning=tuning, ctroct=ctroct,
                                octwidth=octwidth, base_c=base_c, norm=norm)
