"""Sample-rate conversion.

Port of ``torchaudio_contrib_tpu/ops/resample.py``: a rational-ratio
polyphase Kaiser-windowed sinc filter.  The JAX package runs it as one
convolution with input dilation ``p`` and stride ``q``; ``conv1d`` has no
input dilation, so here the zero-stuffed stream is written out and the
same strided convolution runs over it.  The filter is designed once in
float64 NumPy.  Matches ``scipy.signal.resample_poly`` semantics for the
Kaiser-windowed sinc, and is differentiable.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resample"]


@functools.lru_cache(maxsize=32)
def _design_kernel(p: int, q: int, zeros: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for p/q resampling (float64).

    Cutoff at ``min(1/p, 1/q)`` of the upsampled Nyquist; gain ``p`` to
    preserve amplitude after zero-stuffing.  The length is odd, so the
    filter is symmetric about an integer tap (zero phase after the delay
    is trimmed)."""
    cutoff = min(1.0 / p, 1.0 / q)
    half = zeros * max(p, q)
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    taps *= np.kaiser(2 * half + 1, beta)
    taps *= p / np.sum(taps)
    return taps


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             zeros: int = 24,
             beta: float = 14.769656459379492) -> torch.Tensor:
    """Resample ``waveform (..., time)`` from ``orig_freq`` to ``new_freq``.

    Output length is ``ceil(time · new/orig)``.  ``zeros`` controls filter
    sharpness (sinc zero crossings per side).  Identity when the rates
    match.  On a CUDA tensor a float32 convolution runs in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False.
    """
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("sample rates must be positive")
    if orig_freq == new_freq:
        return waveform
    g = math.gcd(int(orig_freq), int(new_freq))
    p = new_freq // g   # upsample factor
    q = orig_freq // g  # downsample factor

    taps64 = _design_kernel(p, q, zeros, beta)
    half = (taps64.shape[0] - 1) // 2

    lead, t = waveform.shape[:-1], waveform.shape[-1]
    x = waveform.reshape(-1, 1, t).to(torch.float32)
    # zero-stuffed stream of length p·(t−1)+1: sample i at index i·p
    up = x.new_zeros((x.shape[0], 1, (t - 1) * p + 1))
    up[..., ::p] = x
    out_len = -(-t * p // q)
    # the taps are symmetric, so correlation (conv1d) equals convolution;
    # output sample k sits at upsampled index k·q with the filter centred
    kern = torch.as_tensor(taps64[::-1].copy(), dtype=torch.float32,
                           device=x.device)[None, None, :]
    y = F.conv1d(F.pad(up, (half, half + p + q)), kern, stride=q)
    y = y[:, 0, :out_len]
    return y.reshape(lead + (out_len,))
