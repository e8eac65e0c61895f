"""MFCC and LFCC: a DCT-II over log-mel (or log-linear) features.

Port of ``torchaudio_contrib_tpu/ops/mfcc.py``.  The orthonormal DCT-II
basis is built once in float64 NumPy and applied as one product over the
filter axis.  ``use_fused=True`` computes the log features with
:func:`~.fused.fused_melspectrogram`: the fused kernels on the GPU (the
backward kernel under autograd), their plain version on the CPU.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .complexops import complex_norm
from .db import amplitude_to_db
from .filters import apply_filterbank, create_linear_filter, create_mel_filter
from .fused import fused_melspectrogram
from .stft import stft

__all__ = ["create_dct", "mfcc", "lfcc"]


@functools.lru_cache(maxsize=16)
def _dct_np(n_mfcc: int, n_input: int, norm: Optional[str]) -> np.ndarray:
    """(n_input, n_mfcc) DCT-II matrix, optionally orthonormal."""
    n = np.arange(n_input, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi / n_input * (n[:, None] + 0.5) * k[None, :])
    if norm == "ortho":
        basis[:, 0] *= 1.0 / np.sqrt(4.0 * n_input)
        basis[:, 1:] *= 1.0 / np.sqrt(2.0 * n_input)
    elif norm is not None:
        raise ValueError(f"unknown norm {norm!r}")
    return basis


def create_dct(n_mfcc: int, n_input: int, norm: Optional[str] = "ortho",
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """DCT-II basis ``(n_input, n_mfcc)`` (``scipy.fft.dct(type=2)`` with
    the same ``norm`` convention)."""
    return torch.as_tensor(_dct_np(int(n_mfcc), int(n_input), norm),
                           dtype=dtype, device=device)


def _cepstrum(waveform, filterbank, n_coeff, fft_length, hop_length, window,
              norm, top_db, center, use_fused, precision):
    """STFT → power → filterbank → dB(power) → DCT-II, with the engine
    rules of the JAX package: ``precision`` needs ``use_fused``, and the
    fused kernels cannot honour ``top_db`` (a per-example max)."""
    if precision != "auto" and not use_fused:
        raise ValueError("precision selects the fused-kernel mode; "
                         "pass use_fused=True with it")
    if use_fused and top_db is not None:
        raise ValueError(
            "use_fused=True cannot honor top_db (a per-example max "
            "reduction cannot run inside the tiled kernel); drop "
            "top_db or use use_fused=False")
    if use_fused:
        feats = fused_melspectrogram(waveform, filterbank, fft_length,
                                     hop_length, window, 2.0, True,
                                     precision=precision, center=center)
    else:
        spec = stft(waveform, fft_length, hop_length, window=window,
                    center=center)
        feats = amplitude_to_db(
            apply_filterbank(complex_norm(spec, 2.0), filterbank),
            power=2.0, top_db=top_db)
    dct = create_dct(n_coeff, filterbank.shape[1], norm, dtype=feats.dtype,
                     device=feats.device)
    return torch.einsum("...mt,mk->...kt", feats, dct)


def _feature_dtype(waveform: torch.Tensor) -> torch.dtype:
    return torch.promote_types(waveform.dtype, torch.float32)


def mfcc(waveform: torch.Tensor,
         sample_rate: float = 22050,
         n_mfcc: int = 20,
         num_mels: int = 128,
         fft_length: int = 2048,
         hop_length: int = 512,
         f_min: float = 0.0,
         f_max: Optional[float] = None,
         window="hann",
         norm: Optional[str] = "ortho",
         top_db: Optional[float] = None,
         center: bool = True,
         use_fused: bool = False,
         precision: str = "auto") -> torch.Tensor:
    """MFCCs of ``waveform (..., time)`` → ``(..., n_mfcc, frames)``:
    STFT → power → mel → dB(power) → DCT-II, differentiable end to end.

    ``use_fused=True`` computes the log-mel with the fused op
    (``precision`` as in :func:`~.fused.fused_melspectrogram`); the power
    is always 2 here, so on a CUDA tensor that always launches the kernel.
    ``top_db`` is incompatible with it and raises, as does ``precision``
    without ``use_fused``.
    """
    fb = create_mel_filter(num_mels, sample_rate, f_min, f_max,
                           fft_length // 2 + 1,
                           dtype=_feature_dtype(waveform),
                           device=waveform.device)
    return _cepstrum(waveform, fb, n_mfcc, fft_length, hop_length, window,
                     norm, top_db, center, use_fused, precision)


def lfcc(waveform: torch.Tensor,
         sample_rate: float = 22050,
         n_lfcc: int = 20,
         n_filter: int = 128,
         fft_length: int = 2048,
         hop_length: int = 512,
         f_min: float = 0.0,
         f_max: Optional[float] = None,
         window="hann",
         norm: Optional[str] = "ortho",
         top_db: Optional[float] = None,
         center: bool = True,
         use_fused: bool = False,
         precision: str = "auto") -> torch.Tensor:
    """Linear-frequency cepstral coefficients ``(..., n_lfcc, frames)``:
    :func:`mfcc`'s chain with the triangular filterbank's corners spaced
    linearly in Hz (:func:`~.filters.create_linear_filter`), torchaudio's
    ``LFCC`` front end.  :func:`mfcc`'s engine rules apply.
    """
    fb = create_linear_filter(n_filter, sample_rate, f_min, f_max,
                              fft_length // 2 + 1,
                              dtype=_feature_dtype(waveform),
                              device=waveform.device)
    return _cepstrum(waveform, fb, n_lfcc, fft_length, hop_length, window,
                     norm, top_db, center, use_fused, precision)
