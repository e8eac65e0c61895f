"""Plain functional ``spectrogram`` / ``melspectrogram``.

Port of ``torchaudio_contrib_tpu/ops/spectro.py`` (forward part): the same
``stft → complex_norm → (mel product)`` chain the layer pipelines run.
For the single-kernel path use :func:`.fused.fused_melspectrogram`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stft import stft
from .complexops import complex_norm
from .filters import create_mel_filter, apply_filterbank

__all__ = ["spectrogram", "melspectrogram"]


def spectrogram(waveform: torch.Tensor,
                fft_length: int = 2048,
                hop_length: Optional[int] = None,
                win_length: Optional[int] = None,
                window=None,
                center: bool = True,
                pad_mode: str = "reflect",
                normalized: bool = False,
                onesided: bool = True,
                power: float = 1.0) -> torch.Tensor:
    """Magnitude spectrogram ``(..., freq, time)``:
    ``complex_norm(stft(waveform, ...), power)``."""
    spec = stft(waveform, fft_length, hop_length, win_length,
                window=window, center=center, pad_mode=pad_mode,
                normalized=normalized, onesided=onesided)
    return complex_norm(spec, power)


def melspectrogram(waveform: torch.Tensor,
                   num_mels: int = 128,
                   sample_rate: float = 22050,
                   f_min: float = 0.0,
                   f_max: Optional[float] = None,
                   filterbank: Optional[torch.Tensor] = None,
                   mel_scale: str = "htk",
                   norm: Optional[str] = None,
                   power: float = 2.0,
                   **spectrogram_kwargs) -> torch.Tensor:
    """Mel spectrogram ``(..., num_mels, time)``.

    ``power`` defaults to 2; pass an explicit ``filterbank (num_bins,
    num_mels)`` to swap scales.  Remaining kwargs flow to
    :func:`spectrogram` (``onesided=False`` is rejected).
    """
    if not spectrogram_kwargs.get("onesided", True):
        raise ValueError("melspectrogram requires onesided=True")
    mag = spectrogram(waveform, power=power, **spectrogram_kwargs)
    if filterbank is None:
        filterbank = create_mel_filter(
            num_mels, sample_rate, f_min, f_max, mag.shape[-2],
            mel_scale=mel_scale, norm=norm, dtype=mag.dtype,
            device=mag.device)
    elif filterbank.shape[0] != mag.shape[-2]:
        raise ValueError(
            f"filterbank rows {filterbank.shape[0]} != spectrogram "
            f"bins {mag.shape[-2]}")
    return apply_filterbank(mag, filterbank)
