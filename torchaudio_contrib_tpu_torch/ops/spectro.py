"""Plain functional ``spectrogram`` / ``melspectrogram``.

Port of ``torchaudio_contrib_tpu/ops/spectro.py``: the same
``stft → complex_norm → (mel product)`` chain the layer pipelines run, and
the torchaudio-signature ``inverse_spectrogram``.
For the single-kernel path use :func:`.fused.fused_melspectrogram`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stft import stft, istft, _resolve_window
from .complexops import complex_norm
from .filters import create_mel_filter, apply_filterbank

__all__ = ["spectrogram", "melspectrogram", "inverse_spectrogram"]


def inverse_spectrogram(spec: torch.Tensor,
                        length: Optional[int] = None,
                        pad: int = 0,
                        window=None,
                        n_fft: int = 400,
                        hop_length: Optional[int] = None,
                        win_length: Optional[int] = None,
                        normalized=False,
                        center: bool = True,
                        pad_mode: str = "reflect",
                        onesided: bool = True) -> torch.Tensor:
    """torchaudio-signature ``functional.inverse_spectrogram``: the
    least-squares inverse of a complex ``spectrogram(..., power=None)``,
    an adapter over :func:`istft` with torchaudio's ``pad`` and
    ``normalized`` conventions (``True``/``"window"`` undo a division by
    ``sqrt(sum(window**2))``, ``"frame_length"`` one by
    ``sqrt(win_length)``).  ``pad_mode`` is accepted for signature symmetry;
    it only affects the forward transform."""
    del pad_mode
    if not torch.is_complex(spec):
        raise ValueError(
            "inverse_spectrogram expects a complex spectrogram "
            "(forward power=None); magnitude spectrograms are not "
            "invertible — use griffin_lim")
    if win_length is None:
        win_length = n_fft
    if normalized:
        if normalized is True or normalized == "window":
            w = _resolve_window(window, win_length, n_fft)
            spec = spec * float((w ** 2).sum()) ** 0.5
        elif normalized == "frame_length":
            spec = spec * float(win_length) ** 0.5
        else:
            raise ValueError(
                f"normalized must be bool|'window'|'frame_length', "
                f"got {normalized!r}")
    out = istft(spec, hop_length=hop_length, win_length=win_length,
                window=window, center=center, normalized=False,
                onesided=onesided,
                length=None if length is None else length + 2 * pad,
                fft_length=n_fft)
    if pad > 0:
        out = out[..., pad:out.shape[-1] - pad]
    return out


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
