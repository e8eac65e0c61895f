"""Constant-Q transform by a spectral kernel (Brown and Puckette).

Port of ``torchaudio_contrib_tpu/ops/cqt.py``.  The constant-Q filters are
built once in the frequency domain (float64 NumPy, cached), and the
transform is one STFT (the port's :func:`~.stft.stft`) and one complex
product with that kernel.  Bin ``k`` has the centre frequency ``f_min ·
2^(k / bins_per_octave)`` and a Hann-windowed complex exponential of
``Q·sr/f_k`` samples, centred in ``fft_length`` and transformed.  Every
filter shares one analysis grid, so ``fft_length`` must cover the longest
(lowest) filter; :func:`cqt` checks it.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .complexops import complex_norm
from .stft import stft as _stft

__all__ = ["cqt_frequencies", "create_cqt_kernel", "cqt", "pseudo_cqt"]


def cqt_frequencies(n_bins: int, f_min: float,
                    bins_per_octave: int = 12) -> np.ndarray:
    """Centre frequencies ``f_min · 2^(k/bins_per_octave)``, ``(n_bins,)``."""
    return f_min * 2.0 ** (np.arange(n_bins) / bins_per_octave)


@functools.lru_cache(maxsize=8)
def _cqt_kernel_np(n_bins: int, f_min: float, bins_per_octave: int,
                   sample_rate: float, fft_length: int,
                   filter_scale: float):
    freqs = cqt_frequencies(n_bins, f_min, bins_per_octave)
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = np.ceil(q * sample_rate / freqs).astype(int)
    if lengths[0] > fft_length:
        raise ValueError(
            f"fft_length={fft_length} is shorter than the lowest-bin "
            f"constant-Q filter ({lengths[0]} samples at {freqs[0]:.1f} "
            f"Hz); use fft_length >= {int(lengths[0])} or raise f_min")
    if freqs[-1] > sample_rate / 2.0:
        raise ValueError(
            f"top CQT bin ({freqs[-1]:.1f} Hz) exceeds Nyquist "
            f"({sample_rate / 2.0:.1f} Hz); lower n_bins or f_min")
    n_freqs = fft_length // 2 + 1
    kt = np.zeros((n_bins, fft_length), np.complex128)
    for k, (fk, lk) in enumerate(zip(freqs, lengths)):
        n = np.arange(lk, dtype=np.float64) - (lk - 1) / 2.0
        win = np.hanning(lk)
        win = win / win.sum()                     # unit DC gain
        start = (fft_length - lk) // 2            # centred in the frame
        kt[k, start:start + lk] = win * np.exp(
            1j * 2.0 * np.pi * fk / sample_rate * n)
    # full-spectrum kernel, conjugated for the analysis inner product
    kc = np.fft.fft(kt, axis=-1).conj() / fft_length
    # folded onto the onesided grid of a real signal's STFT (X Hermitian):
    # Σ_f X[f]·kc[f] = Σ_onesided X·k1 + conj(X)·k2, k2 the reflected
    # negative-frequency slab (zero at DC and Nyquist, counted once)
    k1 = kc[:, :n_freqs]
    k2 = np.zeros_like(k1)
    k2[:, 1:n_freqs - 1] = kc[:, fft_length - np.arange(1, n_freqs - 1)]
    return k1, k2, lengths


def create_cqt_kernel(n_bins: int = 84, f_min: float = 32.703,
                      bins_per_octave: int = 12, sample_rate: float = 22050,
                      fft_length: int = 2048, filter_scale: float = 1.0,
                      dtype: torch.dtype = torch.complex64, device=None):
    """Frequency-domain CQT kernel ``(k1, k2)``, each complex ``(n_bins,
    freq)``: apply to a onesided STFT ``X`` of a real signal as ``k1 @ X +
    k2 @ conj(X)`` (:func:`cqt` does).  ``f_min`` defaults to C1."""
    k1, k2, _ = _cqt_kernel_np(int(n_bins), float(f_min),
                               int(bins_per_octave), float(sample_rate),
                               int(fft_length), float(filter_scale))
    return (torch.as_tensor(k1, dtype=dtype, device=device),
            torch.as_tensor(k2, dtype=dtype, device=device))


def cqt(waveform: torch.Tensor, sample_rate: float = 22050,
        hop_length: int = 512, n_bins: int = 84, f_min: float = 32.703,
        bins_per_octave: int = 12, fft_length: Optional[int] = None,
        filter_scale: float = 1.0, power: float = 1.0) -> torch.Tensor:
    """Constant-Q magnitude spectrogram ``(..., n_bins, time)``: one
    centred STFT with a rectangular window (each filter carries its own
    Hann window) and one complex product with the cached kernel.
    ``fft_length`` defaults to the smallest power of two that covers the
    lowest filter; ``power`` as :func:`~.complexops.complex_norm`."""
    freqs = cqt_frequencies(n_bins, f_min, bins_per_octave)
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    min_len = int(np.ceil(q * sample_rate / freqs[0]))
    if fft_length is None:
        fft_length = 1 << (min_len - 1).bit_length()
    spec = _stft(waveform, fft_length, hop_length, window="rectangular")
    k1, k2 = create_cqt_kernel(n_bins, f_min, bins_per_octave, sample_rate,
                               fft_length, filter_scale, dtype=spec.dtype,
                               device=spec.device)
    out = (torch.einsum("bf,...ft->...bt", k1, spec)
           + torch.einsum("bf,...ft->...bt", k2, spec.conj()))
    return complex_norm(out, power=power)


def pseudo_cqt(mag_specgrams: torch.Tensor, sample_rate: float = 22050,
               n_bins: int = 84, f_min: float = 32.703,
               bins_per_octave: int = 12,
               filter_scale: float = 1.0) -> torch.Tensor:
    """Magnitude-domain CQT approximation ``|kernel| @ |spec|`` of an
    existing onesided magnitude spectrogram ``(..., freq, time)``: cheaper
    and less exact than :func:`cqt`."""
    n_freqs = mag_specgrams.shape[-2]
    k1, _, _ = _cqt_kernel_np(int(n_bins), float(f_min),
                              int(bins_per_octave), float(sample_rate),
                              2 * (n_freqs - 1), float(filter_scale))
    kmag = torch.as_tensor(np.abs(k1), dtype=mag_specgrams.dtype,
                           device=mag_specgrams.device)
    return torch.einsum("bf,...ft->...bt", kmag, mag_specgrams)
