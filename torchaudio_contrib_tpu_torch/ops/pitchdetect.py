"""Pitch detection by normalised cross-correlation (NCCF).

Port of ``torchaudio_contrib_tpu/ops/pitchdetect.py`` (torchaudio's
``detect_pitch_frequency``).  Per frame, a normalised cross-correlation
over the candidate lags picks the period, and a median filter smooths
octave errors.  The correlation for every lag of every frame is one
batched rFFT product (the correlation theorem), the sliding lag energies
one cumulative sum; frames come from the port's
:func:`~.stft.frame_signal`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame_signal

__all__ = ["detect_pitch_frequency"]


def detect_pitch_frequency(waveform: torch.Tensor, sample_rate: float,
                           frame_time: float = 0.01,
                           win_length: int = 30,
                           freq_low: float = 85.0,
                           freq_high: float = 3400.0) -> torch.Tensor:
    """Per-frame fundamental frequency estimate, ``(..., n_out)`` Hz.

    torchaudio's semantics: an NCCF frame is ``frame_time`` seconds
    (frames tile the clip at that stride, ceil count, zero tail padding);
    ``win_length`` is the median window in frames, front-replicated by
    ``(win_length − 1)//2``, so ``n_out = ceil(T/frame) − win_length + 1 +
    (win_length − 1)//2``.  Lags span ``sample_rate/freq_high`` to
    ``sample_rate/freq_low``.
    """
    waveform = waveform.to(torch.promote_types(waveform.dtype,
                                               torch.float32))
    lead, t = waveform.shape[:-1], waveform.shape[-1]
    x = waveform.reshape(-1, t)
    fs = max(int(np.ceil(sample_rate * frame_time)), 1)
    lag_min = max(int(np.ceil(sample_rate / freq_high)), 1)
    lag_max = int(np.ceil(sample_rate / freq_low))
    n_frames = int(np.ceil(t / fs))
    half = (win_length - 1) // 2
    n_out = n_frames - win_length + 1 + half
    if n_out < 1:
        raise ValueError(
            f"waveform too short for pitch detection: {t} samples give "
            f"{n_frames} frames of {fs}; the {win_length}-frame median "
            f"window needs at least {win_length - half}")
    # zero tail padding so that every frame has its full lag reach
    x = F.pad(x, (0, lag_max + n_frames * fs - t))
    ext = fs + lag_max                            # frame + lag tail
    u = frame_signal(x, ext, fs)[:, :n_frames]    # (B, n_frames, ext)
    w = u[..., :fs]                               # reference segment
    # all-lag correlation a[l] = Σ_t w[t]·u[t+l], one rFFT product
    nfft = 1 << int(np.ceil(np.log2(ext + fs)))
    corr = torch.fft.irfft(torch.fft.rfft(w, n=nfft).conj()
                           * torch.fft.rfft(u, n=nfft),
                           n=nfft)[..., :lag_max + 1]
    # sliding energy of u over [l, l + fs) for each lag, by a cumsum
    c2 = F.pad(torch.cumsum(u * u, dim=-1), (1, 0))
    e_u = c2[..., fs:fs + lag_max + 1] - c2[..., :lag_max + 1]
    e_w = e_u[..., :1]                            # lag-0 energy of w
    nccf = corr / torch.sqrt(torch.clamp(e_w * e_u, min=1e-12))
    lags = torch.arange(lag_max + 1, device=x.device)
    nccf = torch.where(lags >= lag_min, nccf,
                       torch.full_like(nccf, -torch.inf))
    best = torch.argmax(nccf, dim=-1)             # (B, n_frames)
    freq = sample_rate / best.to(torch.float32)
    # median smoothing: front-replicated padding, win_length-wide windows
    padded = torch.cat([freq[:, :1].expand(-1, half), freq], dim=-1)
    windows = padded.unfold(-1, win_length, 1)[:, :n_out]
    # the median; of an even window, the mean of the two middle values
    srt = windows.sort(dim=-1).values
    mid = (win_length - 1) // 2
    freq = 0.5 * (srt[..., mid] + srt[..., win_length // 2])
    return freq.reshape(lead + (n_out,))
